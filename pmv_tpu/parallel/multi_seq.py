"""Data-parallel multi-sequence visual odometry.

The reference is inherently single-sequence, single-process. For production
throughput (BASELINE.json configs: "frames/s scaling sweep"), independent
sequences — or independent chunks of one long sequence — are tracked
simultaneously, sharded over the mesh's ``dp`` axis so each chip runs the
full VO step for its own sequences with zero cross-chip communication.

Within a chip the local batch is processed with ``lax.map`` (a scan), NOT
``vmap``: under vmap every ``lax.cond`` lowers to ``select`` so every frame
pays the five-point bootstrap + PnP + BA + reseed simultaneously.
``lax.map`` keeps real per-sequence XLA conditionals, so a chip time-
multiplexes its local sequences at full sequential throughput and the
multi-chip scaling story is per-chip-sequential x dp, still collective-free
(tests/test_parallel_flow.py::test_dp_step_has_no_collectives).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pmv_tpu.pipeline import fused


def batch_states(states: list[fused.StepState]) -> fused.StepState:
    """Stack per-sequence StepStates into one batched state."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *states)


def make_batched_chunk_step(mesh: Mesh | None, cfg: fused.StepConfig):
    """Build a jitted batched chunk step.

    Signature: (state (B, ...), imgs_u8 (B, C, H, W), gt_steps (B, C),
    keys (B, C, 2), K (3, 3)) -> (state, stats). With a mesh, the batch
    dimension is sharded over the 'dp' axis via shard_map — NOT
    jit-with-in_shardings: the SPMD partitioner turns the step's top_k ops
    (corner extraction, RANSAC winner selection) into batch-dim all-gathers,
    shipping every sequence's corner responses to every chip. shard_map
    pins each device to its local batch slice, so the compiled program is
    collective-free (asserted by
    tests/test_parallel_flow.py::test_dp_step_has_no_collectives).
    """
    def batched(state, imgs, gts, keys, K):
        return jax.lax.map(
            lambda args: fused.chunk_step(*args, K, cfg),
            (state, imgs, gts, keys),
        )
    if mesh is None:
        return jax.jit(batched)
    from jax import shard_map

    dp = P("dp")
    sharded = shard_map(
        batched,
        mesh=mesh,
        # Pytree-prefix specs: every StepState/stats leaf shards along its
        # leading (batch) axis; K is replicated.
        in_specs=(dp, dp, dp, dp, P()),
        out_specs=(dp, dp),
        check_vma=False,
    )
    return jax.jit(sharded)
