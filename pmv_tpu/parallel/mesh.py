"""Device-mesh construction helpers.

The reference has no distributed backend at all (single process, one mutex,
a bounded queue — SURVEY.md section 2). This framework scales through
``jax.sharding.Mesh`` axes instead:

- ``dp``  — data parallelism over independent BA windows / sequence chunks
            (the VO analogue of batch data parallelism),
- ``lm``  — landmark-block sharding inside one BA problem (the tensor-
            parallel analogue; the reduced camera system is all-reduced over
            ICI).

Multi-host runs initialize ``jax.distributed`` and lay the same axes over
the global device set.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def make_mesh(dp: int = 1, lm: int | None = None, devices=None) -> Mesh:
    """Build a (dp, lm) mesh over ``devices`` (default: all)."""
    devs = list(devices if devices is not None else jax.devices())
    if lm is None:
        lm = len(devs) // dp
    if dp * lm != len(devs):
        raise ValueError(f"mesh {dp}x{lm} != {len(devs)} devices")
    arr = np.asarray(devs).reshape(dp, lm)
    return Mesh(arr, ("dp", "lm"))


def initialize_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """jax.distributed bootstrap for multi-host pods (DCN across hosts,
    ICI within a slice). Returns True when the process group is (now or
    already) initialized.

    Failures are NOT swallowed: with explicit multi-host arguments a broken
    coordinator must abort the run (silently degrading to single-host would
    corrupt a production job); only the argument-free single-process call
    treats "already initialized" as a benign no-op.
    """
    import logging

    log = logging.getLogger(__name__)
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator,
            num_processes=num_processes,
            process_id=process_id,
        )
        return True
    except RuntimeError as e:
        if "already initialized" in str(e).lower():
            log.info("jax.distributed already initialized: %s", e)
            return True
        if coordinator is None and num_processes is None:
            # Auto-detection outside a managed multi-host environment.
            log.info("jax.distributed auto-init unavailable: %s", e)
            return False
        raise
    except ValueError as e:
        if coordinator is None and num_processes is None:
            log.info("jax.distributed auto-init unavailable: %s", e)
            return False
        raise
