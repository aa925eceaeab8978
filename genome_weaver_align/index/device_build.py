"""Suffix-array construction on the accelerator (prefix doubling over jax sorts).

The reference builds its index with sequential host-side SA-IS
(`UInt32SAIS`); this builder instead uses the accelerator's sort
throughput: Manber–Myers prefix doubling is just two stable argsorts + a
segmented rank assignment per round, O(log n) rounds — all massively
parallel primitives that XLA maps well.  It does O(n log^2 n) work against
SA-IS's O(n); on the GPU it has not been measured against the native build
yet (bench.py ``sa``).

Index-width note: int32 ranks/indices — single text <= 2^31-1 (see
``utils.larray``); whole-genome builds split per chromosome group.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def _lexsort_pairs(primary: jax.Array, secondary: jax.Array) -> jax.Array:
    """argsort by (primary, secondary) via two stable sorts."""
    o1 = jnp.argsort(secondary, stable=True)
    p1 = primary[o1]
    o2 = jnp.argsort(p1, stable=True)
    return o1[o2]


def _doubling_round(k, rank):
    N = rank.shape[0]
    idx = jnp.arange(N, dtype=jnp.int32) + k
    key2 = jnp.where(idx < N, rank[jnp.clip(idx, 0, N - 1)], -1)
    order = _lexsort_pairs(rank, key2)
    r1 = rank[order]
    r2 = key2[order]
    diff = jnp.concatenate(
        [
            jnp.ones(1, jnp.int32),
            ((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])).astype(jnp.int32),
        ]
    )
    new_sorted = jnp.cumsum(diff) - 1
    rank = jnp.zeros_like(rank).at[order].set(new_sorted.astype(jnp.int32))
    return order, rank


@jax.jit
def _sa_device(rank0: jax.Array):
    N = rank0.shape[0]
    max_rounds = int(np.ceil(np.log2(max(N, 2)))) + 1

    def cond(state):
        k, rank, order, done = state
        return jnp.logical_not(done)

    def body(state):
        k, rank, order, _ = state
        order, rank = _doubling_round(k, rank)
        done = rank[order[-1]] == N - 1
        return k * 2, rank, order, done

    k0 = jnp.int32(1)
    order0 = jnp.argsort(rank0, stable=True)
    done0 = rank0[order0[-1]] == N - 1
    _, _, order, _ = jax.lax.while_loop(cond, body, (k0, rank0, order0, done0))
    return order


def suffix_array_device(codes: np.ndarray, device=None) -> np.ndarray:
    """SA of codes+$ computed on the default (or given) jax device."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.size
    if n + 1 > np.iinfo(np.int32).max:
        raise ValueError("text too large for int32 device build; split it")
    rank0 = np.zeros(n + 1, dtype=np.int32)
    rank0[:n] = codes.astype(np.int32) + 1
    arr = jnp.asarray(rank0)
    if device is not None:
        arr = jax.device_put(arr, device)
    order = _sa_device(arr)
    return np.asarray(order).astype(np.int64)
