"""Device meshes and sharding helpers (SURVEY.md §2 P1–P3).

Axes:
- ``data``     — read-cohort data parallelism (reference-free analogue of DP;
                 each device owns a slice of the read batch, index replicated).
- ``interval`` — BWT-interval index sharding for human-scale genomes (the
                 long-context seat in this domain, SURVEY.md §5.7): each
                 device owns a contiguous rank-range of the BWT; per-step
                 rank queries are answered by the owner and merged with psum.

Single-host multi-GPU runs ride NVLink (collectives lower to NCCL);
multi-host extends the same mesh over the network via
``jax.distributed.initialize`` (see ``parallel.multihost``).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
INTERVAL_AXIS = "interval"


def make_mesh(n_data: int | None = None, n_interval: int = 1, devices=None) -> Mesh:
    devices = list(jax.devices() if devices is None else devices)
    if n_data is None:
        n_data = len(devices) // n_interval
    use = np.array(devices[: n_data * n_interval]).reshape(n_data, n_interval)
    return Mesh(use, (DATA_AXIS, INTERVAL_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Reads: first axis split across the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_reads(mesh: Mesh, reads: np.ndarray, lengths: np.ndarray):
    """Pad batch to a multiple of the data-axis size and device_put sharded."""
    import jax.numpy as jnp

    n_data = mesh.shape[DATA_AXIS]
    B = reads.shape[0]
    pad = (-B) % n_data
    if pad:
        reads = np.concatenate([reads, np.zeros((pad,) + reads.shape[1:], reads.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    sh = data_sharding(mesh)
    return (
        jax.device_put(jnp.asarray(reads), sh),
        jax.device_put(jnp.asarray(lengths), sh),
        B,
    )


def replicate_index(mesh: Mesh, dfm):
    """Replicate every array leaf of a DeviceFMIndex across the mesh."""
    rep = replicated(mesh)
    return jax.tree_util.tree_map(lambda a: jax.device_put(a, rep), dfm)
