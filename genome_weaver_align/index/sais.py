"""Suffix-array construction (SURVEY.md §2 #4; reference: SA-IS `UInt32SAIS`).

Three builders, one contract: given 2-bit codes ``T`` of length ``n``, return
the suffix array of ``T$`` (length ``n+1``, ``$`` strictly smallest, so
``SA[0] == n`` always).

- :func:`suffix_array_naive` — sort-all-suffixes oracle for tests.
- :func:`suffix_array` — vectorised NumPy prefix-doubling (Manber–Myers via
  ``np.lexsort``), O(n log n); the portable host builder.
- ``index.native`` provides a C++ SA-IS for large genomes; ``index.device``
  provides a jax.lax.sort prefix-doubling builder that runs on the accelerator.

Index build is offline (reference analogy: the ``BWTransform`` command);
it is not the benchmark hot path.
"""

from __future__ import annotations

import numpy as np


def suffix_array_naive(codes: np.ndarray) -> np.ndarray:
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.size
    text = bytes(codes + 1) + b"\x00"
    return np.array(sorted(range(n + 1), key=lambda i: text[i:]), dtype=np.int64)


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array of T$ (vectorised NumPy)."""
    codes = np.asarray(codes)
    n = codes.size
    N = n + 1
    rank = np.zeros(N, dtype=np.int64)
    rank[:n] = codes.astype(np.int64) + 1  # sentinel rank 0 at position n
    k = 1
    order = None
    while True:
        key2 = np.full(N, -1, dtype=np.int64)
        if k < N:
            key2[: N - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        diff = np.empty(N, dtype=bool)
        diff[0] = True
        diff[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        rank = np.empty(N, dtype=np.int64)
        rank[order] = np.cumsum(diff) - 1
        if rank[order[-1]] == N - 1:
            break
        k *= 2
    return order.astype(np.int64)
