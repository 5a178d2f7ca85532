"""Isolation experiment for the small-Ls weak-scaling gap.

Question: is the sub-0.70 measured efficiency at Ls=8192/shard on the
2-core CPU mesh (a) host memory-system contention — both cores hammering
the same DRAM — or (b) real overhead of the sharded solver?

Experiment: run TWO INDEPENDENT single-core-pinned 1-shard solves
CONCURRENTLY. They communicate nothing and share no sharding machinery; any
slowdown vs the solo pinned baseline is pure memory-system contention. If
that slowdown reproduces the mesh's per-shard slowdown, (a) is proven.

Prints the result as one JSON object.

Usage: python scripts/contention_probe.py   (idle host!)
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def main() -> None:
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=2"
        ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from pmv_tpu.parallel import probe

    results = {}
    for Ls in (8192, 32768):
        print(f"Ls={Ls}: solo + concurrent pinned probes ...", flush=True)
        r = probe.contention_probe(Ls=Ls, iters=3, n_procs=2)
        print(f"  {r}", flush=True)
        results[str(Ls)] = r
        # Mesh comparison point (sharded, same per-shard work, 2 shards).
        t2 = probe.time_sharded_solve(2, Ls, 3)
        solo = r.get("sec_solo_pinned")
        if solo is not None:
            results[str(Ls)]["sec_mesh_2shard"] = t2
            results[str(Ls)]["mesh_efficiency"] = solo / t2
        print(
            f"  mesh 2-shard {t2 * 1e3:.1f} ms -> mesh_eff "
            f"{results[str(Ls)].get('mesh_efficiency', float('nan')):.2f} vs "
            f"zero-comm concurrent eff "
            f"{r.get('zero_comm_efficiency', float('nan')):.2f}",
            flush=True,
        )

    data = {
        "experiment": (
            "two independent single-core-pinned 1-shard solves run "
            "concurrently (zero communication, zero sharding) vs the solo "
            "pinned baseline; if zero_comm_efficiency ~= mesh_efficiency, "
            "the CPU-mesh weak-scaling gap at this Ls is host memory-system "
            "contention, not sharded-solver overhead"
        ),
        "results": results,
    }
    print(json.dumps(data, indent=2))


if __name__ == "__main__":
    main()
