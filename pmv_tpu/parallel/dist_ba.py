"""Distributed bundle adjustment over a (dp, lm) device mesh.

The reference's BA is a single-threaded-process Ceres solve
(CeresBundleAdjustment.cpp:54-61, 4 intra-op threads). Here the problem is
decomposed over the device mesh (BASELINE.json north star):

- **lm axis (tensor-parallel analogue):** the landmark blocks of one window
  are sharded across chips. Each shard assembles its local V / W / b_lm and
  partial U / b_pose / reduced-system terms from its own observation shard;
  the tiny (6P, 6P) reduced camera system is all-reduced across devices
  (``lax.psum``) and solved redundantly on every chip; landmark
  back-substitution stays local. Communication per LM iteration is O(P^2)
  floats — independent of the landmark count.

- **dp axis (data parallelism):** independent BA windows (sequence chunks)
  are processed simultaneously, one per dp slice — the windowed-BA +
  pose-graph-stitching decomposition of a long trajectory
  (pmv_tpu.parallel.pose_graph stitches the results).

Observations must be pre-partitioned by landmark shard: the observation
arrays are sharded along the same axis as the landmarks, and ``obs_lm``
holds *shard-local* landmark indices. ``partition_obs_by_landmark``
performs this layout on the host.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from pmv_tpu.ba import schur_lm
from pmv_tpu.ba.schur_lm import assemble_blocks, schur_solve


def partition_obs_by_landmark(
    obs_uv: np.ndarray,
    obs_pose: np.ndarray,
    obs_lm: np.ndarray,
    obs_mask: np.ndarray,
    n_landmarks: int,
    n_shards: int,
):
    """Host-side layout: pad L to a multiple of n_shards and re-bucket the
    observations so shard s holds exactly the observations of landmarks
    [s*Ls, (s+1)*Ls), with shard-local indices. Returns
    (obs_uv', obs_pose', obs_lm_local', obs_mask', O_per_shard) where the
    primed arrays have shape (n_shards * O_s, ...) laid out shard-major.
    """
    L_pad = -(-n_landmarks // n_shards) * n_shards
    Ls = L_pad // n_shards
    shard_of = obs_lm // Ls
    buckets = [np.where((shard_of == s) & obs_mask)[0] for s in range(n_shards)]
    O_s = max((len(b) for b in buckets), default=1)
    O_s = max(O_s, 1)
    uv = np.zeros((n_shards, O_s, 2), obs_uv.dtype)
    pose = np.zeros((n_shards, O_s), obs_pose.dtype)
    lml = np.zeros((n_shards, O_s), obs_lm.dtype)
    msk = np.zeros((n_shards, O_s), bool)
    for s, b in enumerate(buckets):
        k = len(b)
        uv[s, :k] = obs_uv[b]
        pose[s, :k] = obs_pose[b]
        lml[s, :k] = obs_lm[b] - s * Ls
        msk[s, :k] = True
    return (
        uv.reshape(n_shards * O_s, 2),
        pose.reshape(-1),
        lml.reshape(-1),
        msk.reshape(-1),
        O_s,
        Ls,
    )


def _window_lm_loop(tr, lm, obs_uv, obs_pose, obs_lm, obs_mask, pose_free, K,
                    iters: int, delta: float, axis: str, mode: str = "schur"):
    """LM loop for ONE window with landmark-sharded blocks (runs inside
    shard_map; arrays here are the per-shard locals).

    mode="schur": full joint LM step via the Schur complement (fastest
    convergence; the window needs its gauge fixed externally, e.g. pinned
    poses, or free landmarks can slide the whole solution).

    mode="alternate": block coordinate descent — a pose step against FIXED
    landmarks (each pose an independent damped 6x6 solve; the map anchors
    the gauge, so NO poses need pinning beyond true anchors) followed by a
    local landmark step against fixed poses. This is the trajectory-
    refinement mode: cost decrease cannot trade off against gauge drift.
    Communication per iteration is the same O(P^2) psum either way.
    """

    def local_cost(tr_, lm_):
        r = obs_uv - jax.vmap(lambda t6, x3: schur_lm.geo.ba_project(t6, x3, K))(
            tr_[obs_pose], lm_[obs_lm]
        )
        r2 = jnp.sum(r * r, axis=-1)
        c = jnp.where(obs_mask, schur_lm._huber_cost(r2, delta), 0.0)
        return jax.lax.psum(jnp.sum(c), axis)

    eye6 = jnp.eye(6, dtype=tr.dtype)
    eye3 = jnp.eye(3, dtype=lm.dtype)

    def body_schur(carry, _):
        tr_, lm_, lam, cost = carry
        U, V, Wc, b_pose, b_lm, has_obs = assemble_blocks(
            tr_, lm_, obs_uv, obs_pose, obs_lm, obs_mask, pose_free, K, delta
        )
        dp, dx = schur_solve(
            U, V, Wc, b_pose, b_lm, has_obs, pose_free, lam, psum_axis=axis
        )
        tr_try = tr_ + dp * pose_free[:, None]
        lm_try = lm_ + dx
        cost_try = local_cost(tr_try, lm_try)
        accept = cost_try < cost
        tr_ = jnp.where(accept, tr_try, tr_)
        lm_ = jnp.where(accept, lm_try, lm_)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-9), jnp.minimum(lam * 4.0, 1e6))
        cost = jnp.where(accept, cost_try, cost)
        return (tr_, lm_, lam, cost), cost

    def body_alternate(carry, _):
        tr_, lm_, lam, cost = carry
        # --- pose step (landmarks fixed): U is block-diagonal, each free
        # pose solves its own damped 6x6 normal system ---
        U, _, _, b_pose, _, _ = assemble_blocks(
            tr_, lm_, obs_uv, obs_pose, obs_lm, obs_mask, pose_free, K, delta
        )
        U, b_pose = jax.lax.psum((U, b_pose), axis)
        U_d = U + lam * (U * eye6) + 1e-9 * eye6
        dp = jnp.linalg.solve(U_d, b_pose[..., None])[..., 0]
        tr_try = tr_ + dp * pose_free[:, None]
        cost_try = local_cost(tr_try, lm_)
        accept = cost_try < cost
        tr_ = jnp.where(accept, tr_try, tr_)
        cost = jnp.where(accept, cost_try, cost)
        # --- landmark step (poses fixed): shard-local 3x3 solves ---
        _, V, _, _, b_lm, has_obs = assemble_blocks(
            tr_, lm_, obs_uv, obs_pose, obs_lm, obs_mask, pose_free, K, delta
        )
        V_d = V + lam * (V * eye3) + 1e-9 * eye3
        dx = schur_lm._inv3x3(V_d) @ b_lm[..., None]
        lm_try = lm_ + dx[..., 0] * has_obs[:, None]
        cost_try = local_cost(tr_, lm_try)
        accept = cost_try < cost
        lm_ = jnp.where(accept, lm_try, lm_)
        cost = jnp.where(accept, cost_try, cost)
        lam = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-9), jnp.minimum(lam * 4.0, 1e6))
        return (tr_, lm_, lam, cost), cost

    body = body_schur if mode == "schur" else body_alternate
    cost0 = local_cost(tr, lm)
    (tr, lm, _, cost), _ = jax.lax.scan(
        body, (tr, lm, jnp.asarray(1e-4, tr.dtype), cost0), None, length=iters
    )
    return tr, lm, cost0, cost


def make_distributed_ba(
    mesh: Mesh, iters: int = 5, delta: float = 1.0, mode: str = "schur"
):
    """Build a jitted, shard_mapped multi-window BA solver on ``mesh``.

    ``mode``: "schur" (joint LM, needs per-window gauge pins) or "alternate"
    (pose/landmark block descent, gauge anchored by the map — see
    ``_window_lm_loop``).

    Expected (global) shapes, D windows, L landmarks (divisible by the mesh),
    O observations per window (divisible by the lm axis):

      tr        (D, P, 6)   sharded P('dp')
      lm        (D, L, 3)   sharded P('dp', 'lm')
      obs_uv    (D, O, 2)   sharded P('dp', 'lm')  [shard-major layout]
      obs_pose  (D, O)      sharded P('dp', 'lm')
      obs_lm    (D, O)      shard-LOCAL landmark indices
      obs_mask  (D, O)      sharded P('dp', 'lm')
      pose_free (D, P)      sharded P('dp')
      K         (3, 3)      replicated

    Returns (tr', lm', cost0 (D,), cost (D,)).
    """
    from jax import shard_map

    def shard_fn(tr, lm, obs_uv, obs_pose, obs_lm, obs_mask, pose_free, K):
        # Local shapes: tr (D_s, P, 6); lm (D_s, L_s, 3); obs (D_s, O_s, ...).
        def one_window(tr_w, lm_w, uv_w, pose_w, lml_w, mask_w, free_w):
            return _window_lm_loop(
                tr_w, lm_w, uv_w, pose_w, lml_w, mask_w, free_w, K,
                iters=iters, delta=delta, axis="lm", mode=mode,
            )

        return jax.vmap(one_window)(
            tr, lm, obs_uv, obs_pose, obs_lm, obs_mask, pose_free
        )

    fn = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(
            P("dp"), P("dp", "lm"), P("dp", "lm"), P("dp", "lm"),
            P("dp", "lm"), P("dp", "lm"), P("dp"), P(),
        ),
        out_specs=(P("dp"), P("dp", "lm"), P("dp"), P("dp")),
        check_vma=False,
    )
    return jax.jit(fn)
