"""Myers bit-parallel verify vs. full-DP oracle — exact equality, including
multi-word reads, variable lengths, N codes, and planted indels."""

import numpy as np
import pytest
import jax.numpy as jnp

from genome_weaver_align.ops import dp, myers


def oracle(read, window):
    return dp.edit_distance_semiglobal_host(
        np.asarray(read, np.int64), np.asarray(window, np.int64)
    )


@pytest.mark.parametrize("L,W,nwords", [(20, 30, 1), (40, 60, 2), (100, 130, 4), (150, 200, 5)])
def test_myers_random_vs_oracle(L, W, nwords):
    rng = np.random.default_rng(L)
    Q = 24
    reads = rng.integers(0, 4, size=(Q, L)).astype(np.int32)
    wins = rng.integers(0, 4, size=(Q, W)).astype(np.int32)
    lengths = np.full(Q, L, np.int32)
    got = np.asarray(
        myers.myers_semiglobal(
            jnp.asarray(reads), jnp.asarray(lengths), jnp.asarray(wins), nwords
        )
    )
    want = np.array([oracle(reads[q], wins[q]) for q in range(Q)])
    assert np.array_equal(got, want)


def test_myers_planted_and_variable_length():
    rng = np.random.default_rng(77)
    genome = rng.integers(0, 4, size=5000).astype(np.int32)
    Q, L, W = 32, 64, 90
    reads = np.zeros((Q, L), np.int32)
    wins = np.zeros((Q, W), np.int32)
    lengths = rng.integers(33, L + 1, size=Q).astype(np.int32)
    for q in range(Q):
        l = int(lengths[q])
        p = int(rng.integers(10, genome.size - W - 10))
        tmpl = genome[p : p + l + 3].astype(np.int64).tolist()
        # plant up to 2 subs + 1 indel
        for _ in range(int(rng.integers(0, 3))):
            at = int(rng.integers(0, l))
            tmpl[at] = (tmpl[at] + 1 + int(rng.integers(0, 3))) % 4
        if rng.integers(0, 2):
            del tmpl[int(rng.integers(1, l - 1))]
        reads[q, :l] = tmpl[:l]
        wins[q] = genome[p - 5 : p - 5 + W]
    got = np.asarray(
        myers.myers_semiglobal(
            jnp.asarray(reads), jnp.asarray(lengths), jnp.asarray(wins), 2
        )
    )
    for q in range(Q):
        assert got[q] == oracle(reads[q, : lengths[q]], wins[q]), q


def test_myers_with_n_codes():
    rng = np.random.default_rng(8)
    Q, L, W = 8, 30, 40
    reads = rng.integers(0, 4, size=(Q, L)).astype(np.int32)
    wins = rng.integers(0, 4, size=(Q, W)).astype(np.int32)
    reads[0, 5] = 4  # N in read: never matches
    wins[1, :3] = 4  # N / out-of-range padding in window
    lengths = np.full(Q, L, np.int32)
    got = np.asarray(
        myers.myers_semiglobal(
            jnp.asarray(reads), jnp.asarray(lengths), jnp.asarray(wins), 1
        )
    )
    want = np.array([oracle(reads[q], wins[q]) for q in range(Q)])
    assert np.array_equal(got, want)
