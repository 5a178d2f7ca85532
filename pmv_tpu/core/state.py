"""Static-shape, mask-based pipeline state (the device data model).

The reference keeps a dynamic ``shared_ptr``/``weak_ptr`` graph of features and
landmarks (include/Frame.h:25-27, include/OdometryPipeline.h:49). On the device that
becomes fixed-capacity struct-of-arrays tables with validity masks:

- :class:`FeatureTable` replaces ``Frame::map`` + ``feat_corr``: slot ``i`` in
  frame ``k`` corresponds to slot ``i`` in frame ``k+1`` (LK preserves slot
  order), landmark association is an integer column instead of a weak_ptr.
- :class:`MapState` replaces the global ``feats3d`` vector; erasing a RANSAC
  outlier landmark (OpenCVEPnPSolver.cpp:40-49) becomes clearing an alive bit.

All members are arrays so the whole state is a pytree that flows through jit.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Plain int, NOT jnp.int32: a module-level device constant would initialize
# the XLA backend at import time, breaking jax.distributed.initialize
# ordering for multi-host users (it must run before any backend use).
NO_LANDMARK = -1


class FeatureTable(NamedTuple):
    """Per-frame feature table, capacity ``N`` (static).

    xy:       (N, 2) float32 — (u=column, v=row) pixel positions
    valid:    (N,) bool      — slot holds a live feature
    landmark: (N,) int32     — row into MapState.xyz, or -1 if untracked
    score:    (N,) float32   — detector response (corner strength)
    """

    xy: jax.Array
    valid: jax.Array
    landmark: jax.Array
    score: jax.Array

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    @staticmethod
    def empty(capacity: int, dtype=jnp.float32) -> "FeatureTable":
        return FeatureTable(
            xy=jnp.zeros((capacity, 2), dtype),
            valid=jnp.zeros((capacity,), jnp.bool_),
            landmark=jnp.full((capacity,), NO_LANDMARK, jnp.int32),
            score=jnp.zeros((capacity,), dtype),
        )

    def num_valid(self) -> jax.Array:
        return jnp.sum(self.valid)

    def count_3d(self, map_alive: jax.Array) -> jax.Array:
        """Number of live features bound to a live landmark — the analogue
        of ``Frame::count3DPoints`` (Frame.cpp:14-24), where weak_ptr expiry is
        modelled by the map's alive mask."""
        bound = self.landmark >= 0
        lm = jnp.clip(self.landmark, 0)
        alive = map_alive[lm] & bound
        return jnp.sum(self.valid & alive)


class MapState(NamedTuple):
    """Global landmark table, capacity ``M`` (static ring buffer).

    xyz:   (M, 3) float32 — world-frame landmark positions
    alive: (M,) bool      — landmark exists (cleared on outlier erase)
    head:  () int32       — next ring-allocation slot
    """

    xyz: jax.Array
    alive: jax.Array
    head: jax.Array

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @staticmethod
    def empty(capacity: int, dtype=jnp.float32) -> "MapState":
        return MapState(
            xyz=jnp.zeros((capacity, 3), dtype),
            alive=jnp.zeros((capacity,), jnp.bool_),
            head=jnp.zeros((), jnp.int32),
        )

    def insert(self, pts: jax.Array, mask: jax.Array) -> tuple["MapState", jax.Array]:
        """Ring-insert ``pts`` (N, 3) where ``mask`` (N,) is set.

        Returns the new map and the (N,) int32 slot indices assigned to each
        masked point (-1 where the mask is clear). Static shapes: every point
        gets a reserved slot position via a masked prefix-sum; unmasked points
        write nowhere.
        """
        offsets = jnp.cumsum(mask.astype(jnp.int32)) - 1  # 0-based slot offset
        slots = jnp.where(mask, (self.head + offsets) % self.capacity, -1)
        # Masked-out rows scatter into a dummy pad row (index = capacity) so
        # they can never clobber a real slot.
        scatter_idx = jnp.where(mask, slots, self.capacity).astype(jnp.int32)
        xyz = jnp.concatenate([self.xyz, jnp.zeros_like(self.xyz[:1])])
        xyz = xyz.at[scatter_idx].set(pts.astype(self.xyz.dtype))[: self.capacity]
        alive = jnp.concatenate([self.alive, jnp.zeros_like(self.alive[:1])])
        alive = alive.at[scatter_idx].set(True)[: self.capacity]
        new_head = ((self.head + jnp.sum(mask.astype(jnp.int32))) % self.capacity).astype(
            jnp.int32
        )
        return MapState(xyz=xyz, alive=alive, head=new_head), slots.astype(jnp.int32)

    def kill(self, slots: jax.Array, mask: jax.Array) -> "MapState":
        """Clear alive bits for ``slots`` where ``mask`` — the erase-outlier
        semantics of OpenCVEPnPSolver.cpp:40-49."""
        idx = jnp.where(mask & (slots >= 0), slots, self.capacity).astype(jnp.int32)
        alive = jnp.concatenate([self.alive, jnp.zeros_like(self.alive[:1])])
        alive = alive.at[idx].set(False)[: self.capacity]
        return self._replace(alive=alive)

    def update_points(self, slots: jax.Array, pts: jax.Array, mask: jax.Array) -> "MapState":
        """Write back optimized landmark positions (BA write-back,
        CeresBundleAdjustment.cpp:84-87)."""
        ok = mask & (slots >= 0)
        idx = jnp.where(ok, slots, self.capacity).astype(jnp.int32)
        xyz = jnp.concatenate([self.xyz, jnp.zeros_like(self.xyz[:1])])
        xyz = xyz.at[idx].set(pts.astype(self.xyz.dtype))[: self.capacity]
        return self._replace(xyz=xyz)


def has_neighbor(
    new_xy: jax.Array,
    existing_xy: jax.Array,
    existing_valid: jax.Array,
    dist: int = 5,
) -> jax.Array:
    """Chebyshev-distance neighbor test, vectorized: for each row of
    ``new_xy`` (K, 2), True iff any valid existing feature lies within
    Chebyshev distance < ``dist`` (reference ``Frame::hasNeighbor``,
    Frame.cpp:3-12 with ``Feature::distance`` = max-norm, Feature.cpp:9-15).
    """
    d = jnp.abs(new_xy[:, None, :] - existing_xy[None, :, :])
    cheb = jnp.max(d, axis=-1)
    near = (cheb < dist) & existing_valid[None, :]
    return jnp.any(near, axis=-1)
