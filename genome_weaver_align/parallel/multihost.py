"""Multi-host orchestration (SURVEY.md §5.8, §3.4; acceptance config 5).

One process per host over the network via ``jax.distributed.initialize``; the global
mesh extends the same (data, interval) axes across hosts.  Reads are
streamed data-parallel per host (each host feeds only its addressable
shard of every batch — P1); alignments are gathered to host 0 with
``process_allgather`` and merged in input-read order so the SAM output is
byte-identical to a single-host run.

This module is written so the single-process case degenerates to the local
mesh (tested in CI); N>=2 hosts only changes ``initialize()`` arguments.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import numpy as np


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """jax.distributed.initialize wrapper; no-op for a single process."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


@dataclass
class HostShardInfo:
    process_index: int
    process_count: int
    global_batch: int
    host_batch: int
    host_start: int  # first read index of this host's slice of a batch


def host_shard_info(global_batch: int) -> HostShardInfo:
    pi = jax.process_index()
    pc = jax.process_count()
    assert global_batch % pc == 0, "global batch must divide across hosts"
    hb = global_batch // pc
    return HostShardInfo(pi, pc, global_batch, hb, pi * hb)


def make_global_batch(mesh, host_reads: np.ndarray, host_lengths: np.ndarray):
    """Form a globally-sharded read batch from per-host slices.

    Each host passes ONLY its local reads (host_batch rows); the returned
    global jax.Arrays are data-sharded over the full mesh.  Single-process:
    equivalent to a plain device_put with data sharding.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .mesh import DATA_AXIS

    sharding = NamedSharding(mesh, P(DATA_AXIS))
    pc = jax.process_count()
    if pc == 1:
        import jax.numpy as jnp

        return (
            jax.device_put(jnp.asarray(host_reads), sharding),
            jax.device_put(jnp.asarray(host_lengths), sharding),
        )
    global_shape_r = (host_reads.shape[0] * pc,) + host_reads.shape[1:]
    global_shape_l = (host_lengths.shape[0] * pc,)
    r = jax.make_array_from_process_local_data(sharding, host_reads, global_shape_r)
    l = jax.make_array_from_process_local_data(sharding, host_lengths, global_shape_l)
    return r, l


def gather_to_host(arrays):
    """Fetch fully-addressable copies of result arrays on every host.

    Uses multihost_utils.process_allgather for cross-host results; plain
    np.asarray when single-process.  Results keep global read order, so the
    downstream SAM writer emits identical bytes for any host count.
    """
    if jax.process_count() == 1:
        return [np.asarray(a) for a in arrays]
    from jax.experimental import multihost_utils

    # tiled=True: the global array's shards concatenate along axis 0 in
    # global order (not a stacked per-process axis) — required for
    # non-fully-addressable inputs and exactly the read-order semantics
    # the SAM writer needs
    return [
        np.asarray(multihost_utils.process_allgather(a, tiled=True))
        for a in arrays
    ]


def stream_batches(reads: list, batch_size: int):
    """Deterministic batch iterator: pads the tail so every host sees the
    same number of identically-shaped steps (checkpoint/resume records the
    last completed batch index — reads are independent, SURVEY.md §5.4)."""
    n = len(reads)
    for start in range(0, n, batch_size):
        yield start, reads[start : start + batch_size]
