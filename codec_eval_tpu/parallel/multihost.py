"""Multi-host (DCN) corpus sharding.

The reference is single-process (SURVEY.md §2.5: no distributed backend);
the scale-out story here is: one JAX process per host, a global mesh whose
batch axis spans all hosts' devices, corpus images partitioned across
hosts, and on-device aggregation — the fast intra-host links inside a host,
the data-center network only for the cross-host legs XLA chooses to place
there.

This module cannot be exercised on single-host CI; the mesh/aggregation
machinery itself is covered by the virtual-device tests in
tests/test_parallel.py, and `partition_corpus` is pure logic.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up jax.distributed (idempotent).

    With no arguments, relies on the cluster environment
    (JAX_COORDINATOR_ADDRESS et al.); a plain host with no cluster manager
    needs all three arguments.
    """
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" not in str(e):
            raise


def global_batch_mesh(n_space: int = 1):
    """A (batch, space) mesh over ALL processes' devices.

    Use with ``sharded_score_fn``; each host only materializes its
    local shard of the global batch (jax.make_array_from_process_local_data
    in the runner).
    """
    import jax

    from .mesh import make_mesh

    return make_mesh(
        n_batch=len(jax.devices()) // n_space, n_space=n_space,
        devices=jax.devices(),
    )


def partition_corpus(
    items: Sequence, process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
) -> List:
    """This host's strided share of the corpus (deterministic, balanced).

    Stride partitioning keeps per-host work balanced when image sizes
    cluster by position in the corpus listing.
    """
    import jax

    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    return list(items[pid::n])


def host_local_batch_to_global(mesh, local_batch: np.ndarray):
    """Assemble a globally-sharded array from each host's local batch.

    The global batch dimension is the concatenation of every process's
    local batch (standard multi-host data-parallel input feeding).
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharding = NamedSharding(mesh, P("batch", *([None] * (local_batch.ndim - 1))))
    return jax.make_array_from_process_local_data(sharding, local_batch)


__all__ = [
    "initialize_distributed",
    "global_batch_mesh",
    "partition_corpus",
    "host_local_batch_to_global",
]
