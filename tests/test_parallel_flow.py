"""Integration tests for the data-parallel multi-sequence path and the
global distributed-BA + pose-graph refinement, on the 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pmv_tpu.config import VOConfig
from pmv_tpu.core.state import FeatureTable, MapState
from pmv_tpu.frontend.image import build_pyramid
from pmv_tpu.io import synthetic
from pmv_tpu.parallel import global_refine, mesh as mesh_lib, multi_seq
from pmv_tpu.pipeline import fused
from pmv_tpu.pipeline.odometry import OdometryPipeline


class TestMultiSeq:
    def test_batched_chunk_step_runs_sharded(self):
        B, C, H, W, N, M = 4, 2, 96, 128, 64, 256
        m = mesh_lib.make_mesh(dp=4, lm=2)
        cfg = fused.StepConfig(
            lk_levels=2, lk_window=15, lk_iters=5, tile_h=H, tile_w=W,
            n_per_tile=32, tracked_tol=32, e_hypos=32, pnp_hypos=32,
            bundle_size=3, ba_iters=2, traj_cap=16,
        )
        rng = np.random.default_rng(0)
        states = []
        imgs = []
        for b in range(B):
            seq = synthetic.make_sequence(n_frames=C + 1, shape=(H, W), density=30, seed=b)
            img0 = jnp.asarray(seq["images"][0])
            from pmv_tpu.frontend.corners import grid_extract, select_top

            xy, sc, va = grid_extract(img0, 64, tile_h=H, tile_w=W)
            txy, tsc, tva = select_top(xy, sc, va, N)
            table = FeatureTable(
                xy=txy, valid=tva,
                landmark=jnp.full((N,), -1, jnp.int32), score=tsc,
            )
            states.append(
                fused.init_state(
                    pyr=tuple(build_pyramid(img0, cfg.lk_levels)),
                    table=table, map_state=MapState.empty(M), cfg=cfg,
                )
            )
            imgs.append(seq["images"][1 : C + 1].astype(np.uint8))
        batched = multi_seq.batch_states(states)
        step = multi_seq.make_batched_chunk_step(m, cfg)
        keys = np.asarray(
            jax.vmap(lambda s: jax.random.split(jax.random.PRNGKey(s), C))(
                jnp.arange(B)
            )
        )
        state_out, stats = step(
            batched,
            jnp.asarray(np.stack(imgs)),
            jnp.ones((B, C), jnp.float32),
            jnp.asarray(keys),
            jnp.asarray(np.array(
                [[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32
            )),
        )
        assert state_out.k.shape == (B,)
        assert int(state_out.k[0]) == C
        assert np.isfinite(np.asarray(state_out.t)).all()
        # every sequence tracked a healthy number of features
        assert (np.asarray(stats["tracked"]) > 10).all()

    def test_dp_step_has_no_collectives(self):
        """Scaling contract of the dp axis: sequences are independent, so
        the compiled batched chunk step must contain ZERO cross-device
        collectives — dp throughput scales with chips, limited only by the
        host input feed (the communication half of BASELINE.md's >=70%
        efficiency target; the lm-axis half is test_dist_ba's constant-comm
        test)."""
        import re

        B, C, H, W, N, M = 8, 2, 64, 96, 32, 128
        m = mesh_lib.make_mesh(dp=8, lm=1)
        cfg = fused.StepConfig(
            lk_levels=2, lk_window=9, lk_iters=3, tile_h=H, tile_w=W,
            n_per_tile=16, tracked_tol=8, e_hypos=16, pnp_hypos=16,
            bundle_size=3, ba_iters=1, traj_cap=8,
        )
        rng = np.random.default_rng(0)
        img0 = jnp.asarray(rng.random((H, W)).astype(np.float32) * 100)
        table = FeatureTable(
            xy=jnp.asarray(rng.uniform(10, 50, (N, 2)).astype(np.float32)),
            valid=jnp.ones((N,), bool),
            landmark=jnp.full((N,), -1, jnp.int32),
            score=jnp.ones((N,), jnp.float32),
        )
        st = fused.init_state(
            pyr=tuple(build_pyramid(img0, cfg.lk_levels)),
            table=table, map_state=MapState.empty(M), cfg=cfg,
        )
        batched = multi_seq.batch_states([st] * B)
        step = multi_seq.make_batched_chunk_step(m, cfg)
        imgs = jnp.asarray((rng.random((B, C, H, W)) * 100).astype(np.uint8))
        keys = jnp.asarray(
            np.stack([np.asarray(jax.random.split(jax.random.PRNGKey(b), C)) for b in range(B)])
        )
        K = jnp.asarray(
            np.array([[0.6 * W, 0, W / 2], [0, 0.6 * W, H / 2], [0, 0, 1]], np.float32)
        )
        hlo = step.lower(
            batched, imgs, jnp.ones((B, C), jnp.float32), keys, K
        ).compile().as_text()
        coll = re.compile(
            r"=\s*\(?[^=]*?\)?\s*(all-reduce|all-gather|reduce-scatter|"
            r"collective-permute|all-to-all)(-start)?\("
        )
        offenders = [ln for ln in hlo.splitlines() if coll.search(ln)]
        assert not offenders, f"dp step should be collective-free:\n" + "\n".join(offenders[:5])


class TestGlobalRefine:
    @staticmethod
    def _run_pipe(tmp_path):
        seq = synthetic.make_sequence(n_frames=24, shape=(128, 256), density=60, seed=5)
        paths = synthetic.write_kitti_layout(seq, tmp_path)
        cfg = VOConfig(
            image_dir=paths["image_dir"],
            camera_calibration=paths["camera_calibration"],
            poses=paths["poses"],
            frames=24, init_frames=2, min_tracked_features=200,
            tracked_features_tol=80, bundle_size=5, max_iterations=3,
            feature_capacity=256, map_capacity=2048,
            grid_rows=128, grid_cols=256, lk_window=15,
            chunk_frames=1,  # global refine needs per-frame tables
        )
        pipe = OdometryPipeline(cfg)
        pipe.run_modular()
        return pipe

    @staticmethod
    def _mean_err(pipe, ts, ref):
        return float(
            np.mean([np.linalg.norm(np.asarray(ts[i]) - ref[i]) for i in range(1, len(ts))])
        )

    @staticmethod
    def _inject_drift(pipe, sigma_t=0.3, sigma_r=0.01, seed=7):
        rng = np.random.default_rng(seed)
        for i in range(2, len(pipe.t)):
            pipe.t[i] = pipe.t[i] + rng.normal(0, sigma_t, 3)
            w = rng.normal(0, sigma_r, 3)
            th = np.linalg.norm(w)
            k = w / (th + 1e-12)
            Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
            dR = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
            pipe.R[i] = dR @ pipe.R[i]

    def test_refine_improves_drifted_trajectory(self, tmp_path):
        """The flagship offline-refinement layer must DEMONSTRABLY pull a
        drifted trajectory back: inject pose noise into a finished run and
        require a strict error reduction."""
        pipe = self._run_pipe(tmp_path)
        clean_t = [np.asarray(x).copy() for x in pipe.t]
        gt = pipe.gt_t.copy()
        gt[:, 2] *= -1
        gt_ref = [gt[i + pipe.init_offset] for i in range(len(pipe.t))]

        self._inject_drift(pipe)
        noise_before = self._mean_err(pipe, pipe.t, clean_t)
        gt_before = self._mean_err(pipe, pipe.t, gt_ref)

        m = mesh_lib.make_mesh(dp=2, lm=4)
        R_out, t_out = global_refine.global_bundle_adjust(
            pipe, m, window=8, overlap=4, iters=8
        )
        assert len(R_out) == len(t_out)
        assert np.isfinite(np.stack(t_out)).all()
        noise_after = self._mean_err(pipe, pipe.t, clean_t)
        gt_after = self._mean_err(pipe, pipe.t, gt_ref)
        # strictly better against ground truth...
        assert gt_after < gt_before, f"GT err {gt_before} -> {gt_after}"
        # ...and the injected noise itself must shrink at least 2x
        assert noise_after < noise_before / 2, (
            f"noise {noise_before} -> {noise_after}"
        )

    def test_refine_preserves_clean_trajectory(self, tmp_path):
        """Refining an already-converged run must not degrade it."""
        pipe = self._run_pipe(tmp_path)
        gt = pipe.gt_t.copy()
        gt[:, 2] *= -1
        gt_ref = [gt[i + pipe.init_offset] for i in range(len(pipe.t))]
        before = self._mean_err(pipe, pipe.t, gt_ref)
        m = mesh_lib.make_mesh(dp=2, lm=4)
        global_refine.global_bundle_adjust(pipe, m, window=8, overlap=4, iters=8)
        after = self._mean_err(pipe, pipe.t, gt_ref)
        assert after < before * 1.1 + 0.02, f"{before} -> {after}"


def test_stitch_chain_exact_and_long():
    """stitch_chain: exact recovery of a known chain from (averaged parallel)
    edges, at a length (600 nodes) where the dense f32 GN pose-graph solve
    produced NaN (the round-5 global-refine-at-598 failure)."""
    import numpy as np

    from pmv_tpu.parallel import pose_graph

    rng = np.random.default_rng(0)
    N = 600
    # ground-truth chain
    R = [np.eye(3)]
    t = [np.zeros(3)]
    for k in range(N - 1):
        yaw = 0.004 + 0.001 * np.sin(k * 0.1)
        c, s = np.cos(yaw), np.sin(yaw)
        R_ij = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        t_ij = np.array([0.01, 0.0, -1.0])
        R.append(R_ij @ R[-1])
        t.append(R[-1 - 1 + 1 - 1] @ t_ij + t[-1]) if False else t.append(R[-2] @ t_ij + t[-1])
    R, t = np.stack(R), np.stack(t)
    # edges: 3 parallel noisy copies per pair (like 3 overlapping windows)
    E_idx, E_R, E_t = [], [], []
    for i in range(N - 1):
        R_ij = R[i + 1] @ R[i].T
        t_ij = R[i].T @ (t[i + 1] - t[i])
        for _ in range(3):
            aa = rng.normal(0, 1e-4, 3)
            th = np.linalg.norm(aa)
            k_ = aa / max(th, 1e-12)
            Kx = np.array([[0, -k_[2], k_[1]], [k_[2], 0, -k_[0]], [-k_[1], k_[0], 0]])
            dR = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
            E_idx.append((i, i + 1))
            E_R.append(dR @ R_ij)
            E_t.append(t_ij + rng.normal(0, 1e-4, 3))
    R_out, t_out = pose_graph.stitch_chain(
        N, np.asarray(E_idx), np.stack(E_R), np.stack(E_t), R[0], t[0]
    )
    assert np.isfinite(R_out).all() and np.isfinite(t_out).all()
    # averaged 1e-4 rad edge noise random-walks to ~1 m over the 600 m
    # trajectory; a conditioning failure is 100s of meters or NaN
    assert np.abs(t_out - t).max() < 2.0
    assert np.abs(R_out - R).max() < 1e-2
