"""Checkpoint / resume for pipeline runs.

The reference has no restorable state at all (SURVEY.md section 5 — only the
error file and video are persisted). For long multi-sequence production runs
this framework checkpoints the full pipeline state — trajectory,
heuristic history, landmark map, per-frame feature tables, RNG key, scale —
as a single compressed npz, and can resume mid-sequence.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from pmv_tpu.core.state import FeatureTable, MapState

FORMAT_VERSION = 3  # v3: StepState gained the landmark-snapshot history
# (map_hist); v2 added the per-frame table history


def save(pipe, path: str | Path) -> None:
    """Snapshot an OdometryPipeline mid- or post-run."""
    tables = pipe.tables
    np.savez_compressed(
        path,
        version=FORMAT_VERSION,
        init_offset=pipe.init_offset,
        scale=pipe.scale,
        runtime=pipe.runtime,
        key=np.asarray(pipe._key),
        R=np.stack(pipe.R) if pipe.R else np.zeros((0, 3, 3)),
        t=np.stack(pipe.t) if pipe.t else np.zeros((0, 3)),
        R_s=np.stack(pipe.R_s) if pipe.R_s else np.zeros((0, 3, 3)),
        t_s=np.stack(pipe.t_s) if pipe.t_s else np.zeros((0, 3)),
        map_xyz=np.asarray(pipe.map.xyz),
        map_alive=np.asarray(pipe.map.alive),
        map_head=np.asarray(pipe.map.head),
        tbl_xy=np.stack([np.asarray(tb.xy) for tb in tables]) if tables else np.zeros((0, 0, 2)),
        tbl_valid=np.stack([np.asarray(tb.valid) for tb in tables]) if tables else np.zeros((0, 0), bool),
        tbl_landmark=np.stack([np.asarray(tb.landmark) for tb in tables]) if tables else np.zeros((0, 0), np.int32),
        tbl_score=np.stack([np.asarray(tb.score) for tb in tables]) if tables else np.zeros((0, 0)),
    )


def save_fused_state(state, path: str | Path, **meta) -> None:
    """Snapshot a fused-loop ``StepState`` (pipeline/fused.py) mid-run.

    Everything the production loop threads on device is persisted: the
    per-level LK template blocks, the feature table, the landmark map, the
    current/delta poses, the trajectory history, and the per-frame table
    history (which doubles as the BA window) — so ``chunk_step`` can resume
    mid-sequence bit-identically."""
    data: dict = {"fused_version": FORMAT_VERSION, "n_levels": len(state.blocks)}
    # Blocks are per-level tuples: (region, r0, c0) for the LK matchers, a
    # 1-tuple (prev level-0 image) for knn — save generically.
    for lvl, parts in enumerate(state.blocks):
        data[f"blk{lvl}_n"] = len(parts)
        for j, p in enumerate(parts):
            data[f"blk{lvl}_p{j}"] = np.asarray(p)
    for name in ("xy", "valid", "landmark", "score"):
        data[f"tbl_{name}"] = np.asarray(getattr(state.table, name))
    for name in ("xyz", "alive", "head"):
        data[f"map_{name}"] = np.asarray(getattr(state.map, name))
    for name in (
        "R", "t", "R_s", "t_s", "scale", "k",
        "R_hist", "t_hist",
        "tbl_xy_hist", "tbl_valid_hist", "tbl_lm_hist", "map_hist",
        "ba_overflow",
    ):
        data[name] = np.asarray(getattr(state, name))
    for key, val in meta.items():
        data[f"meta_{key}"] = val
    np.savez_compressed(path, **data)


def load_fused_state(path: str | Path):
    """Restore a fused-loop StepState. Returns (state, meta dict)."""
    from pmv_tpu.pipeline.fused import StepState

    z = np.load(path)
    if int(z["fused_version"]) != FORMAT_VERSION:
        raise ValueError(
            f"fused checkpoint version {z['fused_version']} != {FORMAT_VERSION}"
        )
    blocks = tuple(
        tuple(
            jnp.asarray(z[f"blk{lvl}_p{j}"]) for j in range(int(z[f"blk{lvl}_n"]))
        )
        for lvl in range(int(z["n_levels"]))
    )
    state = StepState(
        blocks=blocks,
        table=FeatureTable(
            xy=jnp.asarray(z["tbl_xy"]),
            valid=jnp.asarray(z["tbl_valid"]),
            landmark=jnp.asarray(z["tbl_landmark"]),
            score=jnp.asarray(z["tbl_score"]),
        ),
        map=MapState(
            xyz=jnp.asarray(z["map_xyz"]),
            alive=jnp.asarray(z["map_alive"]),
            head=jnp.asarray(z["map_head"]),
        ),
        R=jnp.asarray(z["R"]),
        t=jnp.asarray(z["t"]),
        R_s=jnp.asarray(z["R_s"]),
        t_s=jnp.asarray(z["t_s"]),
        scale=jnp.asarray(z["scale"]),
        k=jnp.asarray(z["k"]),
        R_hist=jnp.asarray(z["R_hist"]),
        t_hist=jnp.asarray(z["t_hist"]),
        tbl_xy_hist=jnp.asarray(z["tbl_xy_hist"]),
        tbl_valid_hist=jnp.asarray(z["tbl_valid_hist"]),
        tbl_lm_hist=jnp.asarray(z["tbl_lm_hist"]),
        map_hist=jnp.asarray(z["map_hist"]),
        ba_overflow=jnp.asarray(z["ba_overflow"]),
    )
    meta = {
        key[len("meta_"):]: z[key] for key in z.files if key.startswith("meta_")
    }
    return state, meta


def load(pipe, path: str | Path) -> None:
    """Restore a snapshot into an OdometryPipeline (same config/dataset)."""
    z = np.load(path)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"checkpoint version {z['version']} != {FORMAT_VERSION}")
    pipe.init_offset = int(z["init_offset"])
    pipe.scale = float(z["scale"])
    pipe.runtime = float(z["runtime"])
    pipe._key = jnp.asarray(z["key"])
    pipe.R = [r for r in z["R"]]
    pipe.t = [t for t in z["t"]]
    pipe.R_s = [r for r in z["R_s"]]
    pipe.t_s = [t for t in z["t_s"]]
    pipe.map = MapState(
        xyz=jnp.asarray(z["map_xyz"]),
        alive=jnp.asarray(z["map_alive"]),
        head=jnp.asarray(z["map_head"]),
    )
    pipe.tables = [
        FeatureTable(
            xy=jnp.asarray(z["tbl_xy"][i]),
            valid=jnp.asarray(z["tbl_valid"][i]),
            landmark=jnp.asarray(z["tbl_landmark"][i]),
            score=jnp.asarray(z["tbl_score"][i]),
        )
        for i in range(z["tbl_xy"].shape[0])
    ]
