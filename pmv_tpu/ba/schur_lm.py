"""Sliding-window bundle adjustment: Levenberg-Marquardt with Schur
complement reduction of the landmark blocks — batched JAX.

Replacement for CeresBundleAdjustment.cpp:5-89 (SPARSE_SCHUR,
Huber(1.0), ``max_iterations`` from config). Parameterization is identical to
the reference: each window pose is the 6-vector ``[angle_axis(R^T), -t]``
(CeresBundleAdjustment.cpp:26-34), each landmark a world-frame 3-vector, and
the residual is ``observed - ba_project(tr, X)``
(include/ProjectionResidual.h:38-58).

Structure exploited exactly as SPARSE_SCHUR does, but as dense batched
tensor algebra (batched matmuls): landmark Hessian blocks V are (L, 3, 3) and
inverted in closed form; pose-landmark coupling W is a dense (L, P, 6, 3)
tensor (P = window size <= ~10); the reduced camera system S is a tiny
(6P, 6P) dense solve. The landmark dimension L is the natural sharding axis
for the distributed variant (pmv_tpu.parallel.dist_ba).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from pmv_tpu.core import geometry as geo
from pmv_tpu.core.linalg import gj_solve

_PREC = jax.lax.Precision.HIGHEST


class BAProblem(NamedTuple):
    """Static-shape window BA problem.

    tr:        (P, 6)  pose blocks [angle_axis(R^T), -t]
    lm:        (L, 3)  landmark positions (world frame)
    obs_uv:    (O, 2)  observed pixels
    obs_pose:  (O,)    int32 window-pose index per observation
    obs_lm:    (O,)    int32 landmark index per observation
    obs_mask:  (O,)    bool  observation is real
    pose_free: (P,)    bool  pose participates in optimization (the reference
                       skips global frame 0, CeresBundleAdjustment.cpp:22-23)
    K:         (3, 3)  intrinsics
    """

    tr: jax.Array
    lm: jax.Array
    obs_uv: jax.Array
    obs_pose: jax.Array
    obs_lm: jax.Array
    obs_mask: jax.Array
    pose_free: jax.Array
    K: jax.Array


def _residuals(tr, lm, p: BAProblem):
    """Per-observation residual r = observed - predicted, (O, 2)."""
    tr_o = tr[p.obs_pose]
    lm_o = lm[p.obs_lm]
    pred = geo.ba_project(tr_o, lm_o, p.K)
    return p.obs_uv - pred


def _huber_cost(r2: jax.Array, delta: float) -> jax.Array:
    """Huber rho(s) on squared norms s (Ceres HuberLoss semantics)."""
    d2 = delta * delta
    return jnp.where(r2 <= d2, r2, 2.0 * delta * jnp.sqrt(jnp.maximum(r2, 1e-18)) - d2)


def robust_cost(tr, lm, p: BAProblem, delta: float = 1.0) -> jax.Array:
    r = _residuals(tr, lm, p)
    r2 = jnp.sum(r * r, axis=-1)
    return jnp.sum(jnp.where(p.obs_mask, _huber_cost(r2, delta), 0.0))


def _inv3x3(V: jax.Array) -> jax.Array:
    """Batched closed-form 3x3 inverse via adjugate; (L, 3, 3) -> (L, 3, 3).
    Singular blocks (landmarks with too few observations) return ~0 so their
    update vanishes instead of exploding."""
    a, b, c = V[..., 0, 0], V[..., 0, 1], V[..., 0, 2]
    d, e, f = V[..., 1, 0], V[..., 1, 1], V[..., 1, 2]
    g, h, i = V[..., 2, 0], V[..., 2, 1], V[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    ok = jnp.abs(det) > 1e-12
    inv_det = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    adj = jnp.stack(
        [
            jnp.stack([A, -(b * i - c * h), b * f - c * e], -1),
            jnp.stack([B, a * i - c * g, -(a * f - c * d)], -1),
            jnp.stack([C, -(a * h - b * g), a * e - b * d], -1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def assemble_blocks(tr, lm, obs_uv, obs_pose, obs_lm, obs_mask, pose_free, K, delta):
    """Assemble the Schur building blocks from (a shard of) observations.

    Returns (U (P,6,6), V (L,3,3), Wc (L,P,6,3), b_pose (P,6), b_lm (L,3),
    has_obs (L,)). U and b_pose are *partial sums* when the observations are
    a landmark shard — the distributed solver psums them over the 'lm' mesh
    axis (pmv_tpu.parallel.dist_ba); V/Wc/b_lm are landmark-local.
    """
    P = tr.shape[0]
    L = lm.shape[0]

    def res_one(tr6, X3, uv):
        return uv - geo.ba_project(tr6, X3, K)

    tr_o = tr[obs_pose]
    lm_o = lm[obs_lm]
    r = jax.vmap(res_one)(tr_o, lm_o, obs_uv)  # (O, 2)
    Jp = jax.vmap(jax.jacfwd(res_one, argnums=0))(tr_o, lm_o, obs_uv)  # (O, 2, 6)
    Jl = jax.vmap(jax.jacfwd(res_one, argnums=1))(tr_o, lm_o, obs_uv)  # (O, 2, 3)
    # Masked observations must be inert even when their residual is NaN/Inf
    # (padded slots index arbitrary pose/landmark pairs — e.g. an all-pad
    # landmark shard projects landmark 0 from pose 0, which divides by z=0
    # when pose 0 sits at the origin; NaN * 0-weight is still NaN and one
    # such slot would poison the psummed normal equations).
    r = jnp.where(obs_mask[:, None], r, 0.0)
    Jp = jnp.where(obs_mask[:, None, None], Jp, 0.0)
    Jl = jnp.where(obs_mask[:, None, None], Jl, 0.0)

    r2 = jnp.sum(r * r, axis=-1)
    w = geo.huber_weight(r2, delta) * obs_mask  # IRLS weights (O,)
    # A fixed pose contributes no pose Jacobian, but its observations still
    # constrain the landmarks (anchoring the window better than the
    # reference's drop-frame-0 scheme; callers can reproduce that scheme by
    # clearing obs_mask instead).
    free_obs = pose_free[obs_pose]
    Jp = Jp * free_obs[:, None, None]

    wJp = Jp * w[:, None, None]
    # Block assembly by scatter-add over observations.
    U = jnp.zeros((P, 6, 6), tr.dtype).at[obs_pose].add(
        jnp.einsum("oik,oij->okj", wJp, Jp, precision=_PREC)
    )
    V = jnp.zeros((L, 3, 3), lm.dtype).at[obs_lm].add(
        jnp.einsum("oik,oij->okj", Jl * w[:, None, None], Jl, precision=_PREC)
    )
    # W coupling: (L, P, 6, 3) — each (pose, landmark) pair has <= 1 obs.
    Wc = jnp.zeros((L, P, 6, 3), tr.dtype).at[obs_lm, obs_pose].add(
        jnp.einsum("oik,oij->okj", wJp, Jl, precision=_PREC)
    )
    # Gradient (note sign: minimize 1/2 w r^2 with J = dr/dtheta -> solve
    # H delta = -J^T w r; fold the minus into b).
    b_pose = jnp.zeros((P, 6), tr.dtype).at[obs_pose].add(
        -jnp.einsum("oik,oi->ok", wJp, r, precision=_PREC)
    )
    b_lm = jnp.zeros((L, 3), lm.dtype).at[obs_lm].add(
        -jnp.einsum("oik,oi->ok", Jl * w[:, None, None], r, precision=_PREC)
    )
    has_obs = jnp.zeros((L,), jnp.int32).at[obs_lm].add(obs_mask.astype(jnp.int32)) > 0
    return U, V, Wc, b_pose, b_lm, has_obs


def assemble_blocks_grid(tr, lm, obs_uv, local, obs_mask, onehot, pose_free, K, delta):
    """Grid-structured assembly: observations laid out (P, N) pose-major
    (slot-aligned windows observe each landmark at most once per pose), with
    landmark membership as a precomputed one-hot ``onehot`` (P, N, L) — or
    ``None`` to build it in landmark chunks on the fly (the high-density
    configs' (P, N, L) one-hot would be hundreds of MB; chunking keeps the
    same matmul assembly at ~32 MB of working set and identical f32
    results, since each observation matches exactly one chunk).

    Semantically identical to :func:`assemble_blocks` (up to f32 summation
    order), but the five scatter-adds become dense einsums — one-hot
    contractions are plain matmuls with a fixed output layout and no
    write conflicts.
    The one-hot is iteration-invariant, so callers build it once per solve
    when it fits.

    Returns (U (P,6,6), V (L,3,3), Wc (L,P,6,3), b_pose (P,6), b_lm (L,3),
    has_obs (L,)).
    """
    P, N = obs_mask.shape
    L = lm.shape[0]
    tr_o = jnp.broadcast_to(tr[:, None, :], (P, N, 6))
    lm_o = lm[local]  # (P, N, 3)

    def res_one(tr6, X3, uv):
        return uv - geo.ba_project(tr6, X3, K)

    r = jax.vmap(jax.vmap(res_one))(tr_o, lm_o, obs_uv)  # (P, N, 2)
    Jp = jax.vmap(jax.vmap(jax.jacfwd(res_one, argnums=0)))(tr_o, lm_o, obs_uv)
    Jl = jax.vmap(jax.vmap(jax.jacfwd(res_one, argnums=1)))(tr_o, lm_o, obs_uv)
    # Inert masked slots even when their residual is NaN/Inf (see
    # assemble_blocks).
    r = jnp.where(obs_mask[..., None], r, 0.0)
    Jp = jnp.where(obs_mask[..., None, None], Jp, 0.0)
    Jl = jnp.where(obs_mask[..., None, None], Jl, 0.0)

    r2 = jnp.sum(r * r, axis=-1)
    w = geo.huber_weight(r2, delta) * obs_mask  # (P, N)
    Jp = Jp * pose_free[:, None, None, None]
    wJp = Jp * w[..., None, None]
    wJl = Jl * w[..., None, None]

    U = jnp.einsum("pnik,pnij->pkj", wJp, Jp, precision=_PREC)
    b_pose = -jnp.einsum("pnik,pni->pk", wJp, r, precision=_PREC)
    VV = jnp.einsum("pnik,pnij->pnkj", wJl, Jl, precision=_PREC).reshape(P, N, 9)
    WW = jnp.einsum("pnik,pnij->pnkj", wJp, Jl, precision=_PREC).reshape(P, N, 18)
    bl = -jnp.einsum("pnik,pni->pnk", wJl, r, precision=_PREC)
    mask_f = obs_mask.astype(tr.dtype)

    def lm_chunk(oh, Lc):
        """V/Wc/b_lm/has_obs for one landmark chunk from its one-hot."""
        V_c = jnp.einsum("pnl,pnx->lx", oh, VV, precision=_PREC).reshape(Lc, 3, 3)
        Wc_c = jnp.einsum("pnl,pnx->lpx", oh, WW, precision=_PREC).reshape(
            Lc, P, 6, 3
        )
        b_c = jnp.einsum("pnl,pnk->lk", oh, bl, precision=_PREC)
        has_c = jnp.einsum("pnl,pn->l", oh, mask_f, precision=_PREC) > 0
        return V_c, Wc_c, b_c, has_c

    if onehot is not None:
        V, Wc, b_lm, has_obs = lm_chunk(onehot, L)
    else:
        # ~8M f32 elements (32 MB) of one-hot per chunk. Unrolled python
        # loop, NOT lax.map: the chunk count is static and small, and the
        # unrolled program keeps the fused loop's cond-inside-scan free of
        # a nested loop.
        Lc = max(1, min(L, (8 * 2**20) // max(P * N, 1)))
        n_chunks = -(-L // Lc)
        parts = []
        for c in range(n_chunks):
            ids = c * Lc + jnp.arange(Lc, dtype=local.dtype)
            oh = (
                (local[..., None] == ids) & obs_mask[..., None]
            ).astype(tr.dtype)
            parts.append(lm_chunk(oh, Lc))
        V = jnp.concatenate([p[0] for p in parts])[:L]
        Wc = jnp.concatenate([p[1] for p in parts])[:L]
        b_lm = jnp.concatenate([p[2] for p in parts])[:L]
        has_obs = jnp.concatenate([p[3] for p in parts])[:L]
    return U, V, Wc, b_pose, b_lm, has_obs


def _lm_loop(tr, lm, lam0, iters, step_fn, cost_fn):
    """The shared LM accept/damping loop (both ba_solve and ba_solve_grid
    must stay in lockstep — this is the single copy).

    ``step_fn(tr, lm, lam) -> (tr_try, lm_try)`` proposes a damped step;
    ``cost_fn(tr, lm)`` evaluates the robust cost. Accept iff the cost
    decreases; on accept lam /= 3 (floored at 1e-6 — in f32 a near-zero lam
    lets the Schur solve amplify rounding noise along weakly-observed
    directions), on reject lam *= 4 (capped at 1e6).
    """

    def body(carry, _):
        tr_c, lm_c, lam, cost = carry
        tr_try, lm_try = step_fn(tr_c, lm_c, lam)
        cost_try = cost_fn(tr_try, lm_try)
        accept = cost_try < cost
        tr_c = jnp.where(accept, tr_try, tr_c)
        lm_c = jnp.where(accept, lm_try, lm_c)
        lam = jnp.where(
            accept, jnp.maximum(lam / 3.0, 1e-6), jnp.minimum(lam * 4.0, 1e6)
        )
        cost = jnp.where(accept, cost_try, cost)
        return (tr_c, lm_c, lam, cost), cost

    cost0 = cost_fn(tr, lm)
    (tr, lm, _, cost), hist = jax.lax.scan(
        body, (tr, lm, jnp.asarray(lam0, tr.dtype), cost0), None, length=iters
    )
    return tr, lm, {"cost0": cost0, "cost": cost, "history": hist}


def _cost_grid(tr, lm, obs_uv, local, obs_mask, K, delta):
    """Huber cost over (P, N)-grid observations (robust_cost's grid twin)."""
    tr_o = jnp.broadcast_to(tr[:, None, :], obs_mask.shape + (6,))
    pred = geo.ba_project(tr_o, lm[local], K)
    r = obs_uv - pred
    r2 = jnp.sum(r * r, axis=-1)
    return jnp.sum(jnp.where(obs_mask, _huber_cost(r2, delta), 0.0))


@functools.partial(jax.jit, static_argnames=("iters", "delta", "obs_gate_px"))
def ba_solve_grid(
    tr,
    lm,
    obs_uv,
    local,
    obs_mask,
    pose_free,
    K,
    iters: int = 5,
    delta: float = 1.0,
    lam0: float = 1e-4,
    obs_gate_px: float = 0.0,
):
    """:func:`ba_solve` over (P, N)-grid observations with one-hot matmul
    assembly — the production fused path's BA solver (pipeline.fused.ba_step).
    Same LM loop, damping, gating and return contract as ba_solve; obs_uv /
    local / obs_mask are (P, N[, 2]) instead of flat (O,) arrays."""
    if obs_gate_px > 0:
        pred = geo.ba_project(
            jnp.broadcast_to(tr[:, None, :], obs_mask.shape + (6,)), lm[local], K
        )
        r0 = obs_uv - pred
        ok = jnp.sum(r0 * r0, axis=-1) < obs_gate_px * obs_gate_px
        obs_mask = obs_mask & ok

    L = lm.shape[0]
    P, N = obs_mask.shape
    # Precompute the iteration-invariant one-hot when it fits (<=128 MB
    # f32): the chunked fallback rebuilds the one-hot inside EVERY LM
    # iteration. The H100 has 80 GB of device memory, so a transient
    # 128 MB one-hot is cheap; only the largest high-density windows
    # (L_win 8192 at N=2048: 335 MB) take the chunked path. Which
    # assembly path is faster on the GPU is not measured yet (it waits
    # for a trace of the BA call).
    if P * N * L <= 32 * 2**20:
        onehot = (
            (local[..., None] == jnp.arange(L, dtype=local.dtype))
            & obs_mask[..., None]
        ).astype(tr.dtype)
    else:
        onehot = None

    def step_fn(tr_c, lm_c, lam):
        U, V, Wc, b_pose, b_lm, has_obs = assemble_blocks_grid(
            tr_c, lm_c, obs_uv, local, obs_mask, onehot, pose_free, K, delta
        )
        dp, dx = schur_solve(U, V, Wc, b_pose, b_lm, has_obs, pose_free, lam)
        return tr_c + dp * pose_free[:, None], lm_c + dx

    def cost_fn(tr_c, lm_c):
        return _cost_grid(tr_c, lm_c, obs_uv, local, obs_mask, K, delta)

    return _lm_loop(tr, lm, lam0, iters, step_fn, cost_fn)


def schur_solve(U, V, Wc, b_pose, b_lm, has_obs, pose_free, lam, *, psum_axis=None):
    """Damped Schur-complement solve from assembled blocks.

    When ``psum_axis`` is given, U/b_pose and the reduced system partials are
    all-reduced over that mesh axis (landmark-sharded distributed BA); the
    tiny (6P, 6P) solve is then performed redundantly on every shard, and
    the landmark back-substitution stays local. Returns (dp (P,6), dx (L,3)).
    """
    P = b_pose.shape[0]
    dtype = b_pose.dtype
    eyeP = jnp.eye(6, dtype=dtype)
    eyeL = jnp.eye(3, dtype=dtype)
    # f32 gauge hygiene: the window often has NO pinned pose (reference
    # semantics, CeresBundleAdjustment.cpp:22-24 skips only global frame 0),
    # so the normal equations carry a 7-DOF null space. Ceres survives it in
    # double precision; in f32 the gradient's numerical null-space component
    # (~1e-7 relative) divided by a near-zero damped eigenvalue produces
    # meter-scale gauge jumps. A scale-aware absolute Tikhonov term caps the
    # null-direction step at ~noise/mu while staying ~1e-6 relative to the
    # data directions (diag(U) sets the problem's scale).
    # (muV is per-landmark-block so the landmark-sharded and single-device
    # paths compute identical damping regardless of shard boundaries.)
    muV = (
        1e-6 * jnp.mean(jnp.abs(jnp.diagonal(V, axis1=-2, axis2=-1)), axis=-1)
        + 1e-9
    )[:, None, None]
    V_d = V + lam * (V * eyeL) + muV * eyeL

    V_inv = _inv3x3(V_d)  # (L, 3, 3)
    Y = jnp.einsum("lpij,ljk->lpik", Wc, V_inv, precision=_PREC)  # (L, P, 6, 3)

    # Reduced camera system S = U_d - sum_l W V^-1 W^T. The correction terms
    # depend only on landmark-local blocks, so the sharded path defers the
    # U/b_pose reduction and ships everything in ONE fused all-reduce per LM
    # iteration (4 adjacent psums XLA combines; the payload — ~4.6 KB at
    # P=5 — is unchanged, but the barrier count per iteration drops 4 -> 1,
    # which is the dominant sharding overhead in the latency-bound regime).
    S_corr = jnp.einsum("lpik,lqjk->piqj", Y, Wc, precision=_PREC)
    b_corr = jnp.einsum("lpik,lk->pi", Y, b_lm, precision=_PREC)
    if psum_axis is not None:
        U, b_pose, S_corr, b_corr = jax.lax.psum(
            (U, b_pose, S_corr, b_corr), psum_axis
        )
    muP = 1e-6 * jnp.mean(jnp.abs(jnp.diagonal(U, axis1=-2, axis2=-1))) + 1e-9
    U_d = U + lam * (U * eyeP) + muP * eyeP
    S = jnp.zeros((P, 6, P, 6), dtype)
    S = S.at[jnp.arange(P), :, jnp.arange(P), :].add(U_d)
    S = S - S_corr
    b_red = b_pose - b_corr

    # Pin non-free poses: identity rows/cols, zero rhs.
    m6 = jnp.repeat(pose_free, 6).astype(dtype)  # (6P,)
    S_flat = S.reshape(6 * P, 6 * P)
    S_flat = S_flat * m6[:, None] * m6[None, :] + jnp.diag(1.0 - m6)
    b_flat = b_red.reshape(-1) * m6

    # Pivot-free Gauss-Jordan on the Jacobi-scaled system D S D y = D b,
    # dp = D y, D = diag(S)^-1/2: S is Tikhonov+LM-damped SPD, so its
    # diagonal is positive (pinned rows carry an explicit unit diagonal).
    # Rotation and translation columns differ in scale by about the focal
    # length; unscaled, the f32 pivots lose the step (a P=10, 8192-landmark
    # window's first step reached cost 173609 in f32 vs 35384 in f64 on the
    # CPU; scaled f32 gives 35384.26).
    d = jax.lax.rsqrt(jnp.diagonal(S_flat))
    y = gj_solve(S_flat * d[:, None] * d[None, :], (b_flat * d)[:, None])[:, 0]
    dp = (y * d).reshape(P, 6)
    # Back-substitute landmarks: dx = V^-1 (b_lm - W^T dp).
    Wt_dp = jnp.einsum("lpik,pi->lk", Wc, dp, precision=_PREC)
    dx = jnp.einsum("ljk,lk->lj", V_inv, b_lm - Wt_dp, precision=_PREC)
    dx = dx * has_obs[:, None]
    return dp, dx


def _lm_step(tr, lm, p: BAProblem, lam, delta: float):
    """One damped LM step. Returns (tr_new, lm_new)."""
    U, V, Wc, b_pose, b_lm, has_obs = assemble_blocks(
        tr, lm, p.obs_uv, p.obs_pose, p.obs_lm, p.obs_mask, p.pose_free, p.K, delta
    )
    dp, dx = schur_solve(U, V, Wc, b_pose, b_lm, has_obs, p.pose_free, lam)
    tr_new = tr + dp * p.pose_free[:, None]
    lm_new = lm + dx
    return tr_new, lm_new


@functools.partial(jax.jit, static_argnames=("iters", "delta", "obs_gate_px"))
def ba_solve(
    p: BAProblem,
    iters: int = 5,
    delta: float = 1.0,
    lam0: float = 1e-4,
    obs_gate_px: float = 0.0,
) -> tuple[jax.Array, jax.Array, dict]:
    """Run ``iters`` LM iterations (the config's ``max_iterations``,
    matching CeresBundleAdjustment.cpp:59). Returns (tr, lm, stats).

    ``obs_gate_px`` > 0 drops observations whose INITIAL reprojection
    residual exceeds the gate before solving — the standard defense against
    corrupted associations (tracks that slid onto moving objects / occluder
    edges), which Huber alone cannot contain when they are numerous. The
    reference has no such gate (set 0 for strict parity); on the combined
    stress scenario (turns + occluders + noise) an un-gated window BA can
    diverge (ATE 94 m vs 9.5 m without BA on one seed)."""
    if obs_gate_px > 0:
        r0 = _residuals(p.tr, p.lm, p)
        ok = jnp.sum(r0 * r0, axis=-1) < obs_gate_px * obs_gate_px
        p = p._replace(obs_mask=p.obs_mask & ok)

    def step_fn(tr, lm, lam):
        return _lm_step(tr, lm, p, lam, delta)

    def cost_fn(tr, lm):
        return robust_cost(tr, lm, p, delta)

    return _lm_loop(p.tr, p.lm, lam0, iters, step_fn, cost_fn)
