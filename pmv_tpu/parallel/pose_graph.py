"""Pose-graph optimization — the window-stitching layer.

The reference processes one global sliding window sequentially; the
distributed design (BASELINE.json north star) instead bundle-adjusts many
windows in parallel (pmv_tpu.parallel.dist_ba) and reconciles them here: each
window contributes relative-pose edges between its frames, and a damped
Gauss-Newton pose graph solves for globally consistent absolute poses.

Pose convention matches the pipeline (reference composition semantics,
OdometryPipeline.cpp:180-181): an edge (i, j) measures (R_ij, t_ij) with
``R_j = R_ij R_i`` and ``t_j = R_i t_ij + t_i``.

The normal system is assembled as dense 6N x 6N (N is a few hundred
keyframes), with per-edge 6x6 blocks scatter-added — the dense
equivalent of a sparse pose-graph solver.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from pmv_tpu.core import geometry as geo

_PREC = jax.lax.Precision.HIGHEST


def edge_residual(params_i: jax.Array, params_j: jax.Array,
                  meas_R: jax.Array, meas_t: jax.Array) -> jax.Array:
    """6-vector residual of one edge; params are [angle_axis(R), t] per node."""
    R_i = geo.rodrigues(params_i[:3])
    R_j = geo.rodrigues(params_j[:3])
    t_i = params_i[3:]
    t_j = params_j[3:]
    pred_R = jnp.matmul(R_j, R_i.T, precision=_PREC)
    pred_t = jnp.matmul(R_i.T, (t_j - t_i)[:, None], precision=_PREC)[:, 0]
    dR = jnp.matmul(pred_R, meas_R.T, precision=_PREC)
    # Rotation residual: vee of the skew part, ~= sin(theta) * axis. Unlike
    # the full log map, this is autodiff-safe at the identity (arccos'
    # diverges there), and equivalent for the small edge errors of a VO
    # pose graph.
    r_rot = 0.5 * jnp.stack(
        [dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]
    )
    r_t = pred_t - meas_t
    return jnp.concatenate([r_rot, r_t])


@functools.partial(jax.jit, static_argnames=("iters",))
def optimize(
    poses_R: jax.Array,   # (N, 3, 3)
    poses_t: jax.Array,   # (N, 3)
    edges: jax.Array,     # (E, 2) int32 node indices (i, j)
    meas_R: jax.Array,    # (E, 3, 3)
    meas_t: jax.Array,    # (E, 3)
    edge_weight: jax.Array,  # (E,)
    anchored: jax.Array,  # (N,) bool — nodes held fixed (at least node 0)
    iters: int = 10,
    lam: float = 1e-6,
) -> tuple[jax.Array, jax.Array]:
    """Damped Gauss-Newton pose-graph solve. Returns (R (N,3,3), t (N,3))."""
    N = poses_t.shape[0]
    params0 = jnp.concatenate([jax.vmap(geo.rodrigues_inv)(poses_R), poses_t], axis=1)

    res_fn = jax.vmap(edge_residual, in_axes=(0, 0, 0, 0))
    jac_i = jax.vmap(jax.jacfwd(edge_residual, argnums=0), in_axes=(0, 0, 0, 0))
    jac_j = jax.vmap(jax.jacfwd(edge_residual, argnums=1), in_axes=(0, 0, 0, 0))

    free = (~anchored).astype(params0.dtype)

    def body(_, params):
        pi = params[edges[:, 0]]
        pj = params[edges[:, 1]]
        r = res_fn(pi, pj, meas_R, meas_t) * edge_weight[:, None]  # (E, 6)
        Ji = jac_i(pi, pj, meas_R, meas_t) * edge_weight[:, None, None]  # (E, 6, 6)
        Jj = jac_j(pi, pj, meas_R, meas_t) * edge_weight[:, None, None]
        # Dense 6N x 6N normal matrix via block scatter-add.
        H = jnp.zeros((N, 6, N, 6), params.dtype)
        b = jnp.zeros((N, 6), params.dtype)
        ii = edges[:, 0]
        jj = edges[:, 1]
        H = H.at[ii, :, ii, :].add(jnp.einsum("eki,ekj->eij", Ji, Ji, precision=_PREC))
        H = H.at[jj, :, jj, :].add(jnp.einsum("eki,ekj->eij", Jj, Jj, precision=_PREC))
        H = H.at[ii, :, jj, :].add(jnp.einsum("eki,ekj->eij", Ji, Jj, precision=_PREC))
        H = H.at[jj, :, ii, :].add(jnp.einsum("eki,ekj->eij", Jj, Ji, precision=_PREC))
        b = b.at[ii].add(-jnp.einsum("eki,ek->ei", Ji, r, precision=_PREC))
        b = b.at[jj].add(-jnp.einsum("eki,ek->ei", Jj, r, precision=_PREC))
        m6 = jnp.repeat(free, 6)
        Hf = H.reshape(6 * N, 6 * N)
        Hf = Hf * m6[:, None] * m6[None, :] + jnp.diag(1.0 - m6 + lam)
        bf = b.reshape(-1) * m6
        dp = jnp.linalg.solve(Hf, bf).reshape(N, 6)
        return params + dp * free[:, None]

    params = jax.lax.fori_loop(0, iters, body, params0)
    return jax.vmap(geo.rodrigues)(params[:, :3]), params[:, 3:]


def stitch_chain(
    n_nodes: int,
    edges,      # (E, 2) int — must all be consecutive pairs (i, i+1)
    meas_R,     # (E, 3, 3)
    meas_t,     # (E, 3)
    R0,         # (3, 3) anchor pose of node 0
    t0,         # (3,)
):
    """Exact chain stitch: average the parallel edges of every consecutive
    pair (chordal rotation mean via SVD projection, arithmetic translation
    mean) and compose absolute poses from the node-0 anchor. O(N) host-side
    float64 numpy.

    VO window edges form a PURE CHAIN (window_edges emits only (i, i+1)
    pairs; overlapping windows contribute parallel edges), and the dense
    Gauss-Newton ``optimize`` on a chain is exactly equivalent to edge
    averaging — but its 6N x 6N float32 normal solve has a chain-Laplacian
    condition number growing ~N^2 and produces NaN around N~600 (measured:
    fine at 150 nodes, NaN at 596). This closed form is exact, f64, and
    has no conditioning limit; ``optimize`` remains for graphs with
    loop-closure edges.
    """
    import numpy as np

    edges = np.asarray(edges)
    assert (edges[:, 1] - edges[:, 0] == 1).all(), "stitch_chain needs a chain"
    mR = np.asarray(meas_R, np.float64)
    mt = np.asarray(meas_t, np.float64)
    # Accumulate per-pair sums.
    sum_R = np.zeros((n_nodes - 1, 3, 3))
    sum_t = np.zeros((n_nodes - 1, 3))
    cnt = np.zeros(n_nodes - 1)
    np.add.at(sum_R, edges[:, 0], mR)
    np.add.at(sum_t, edges[:, 0], mt)
    np.add.at(cnt, edges[:, 0], 1.0)
    R_out = np.empty((n_nodes, 3, 3))
    t_out = np.empty((n_nodes, 3))
    R_out[0] = np.asarray(R0, np.float64)
    t_out[0] = np.asarray(t0, np.float64)
    for i in range(n_nodes - 1):
        if cnt[i] > 0:
            # Chordal mean: project the summed rotations back onto SO(3).
            U, _, Vt = np.linalg.svd(sum_R[i])
            D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
            R_ij = U @ D @ Vt
            t_ij = sum_t[i] / cnt[i]
        else:  # gap in coverage: identity edge (carry the previous pose)
            R_ij = np.eye(3)
            t_ij = np.zeros(3)
        # Composition convention: R_j = R_ij R_i; t_j = R_i t_ij + t_i.
        R_out[i + 1] = R_ij @ R_out[i]
        t_out[i + 1] = R_out[i] @ t_ij + t_out[i]
    return R_out, t_out


def window_edges(window_frames: list[list[int]], window_R: list, window_t: list):
    """Build pose-graph edges from per-window absolute poses: one edge per
    consecutive pair inside each window (windows overlap, so overlapping
    pairs contribute multiple consistent edges). Returns (edges (E,2),
    meas_R (E,3,3), meas_t (E,3)) as numpy arrays."""
    import numpy as np

    E_idx, E_R, E_t = [], [], []
    for frames, Rs, ts in zip(window_frames, window_R, window_t):
        for a in range(len(frames) - 1):
            i, j = frames[a], frames[a + 1]
            R_ij = np.asarray(Rs[a + 1]) @ np.asarray(Rs[a]).T
            t_ij = np.asarray(Rs[a]).T @ (np.asarray(ts[a + 1]) - np.asarray(ts[a]))
            E_idx.append((i, j))
            E_R.append(R_ij)
            E_t.append(t_ij)
    return np.asarray(E_idx, np.int32), np.stack(E_R), np.stack(E_t)
