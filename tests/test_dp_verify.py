"""Banded DP verify vs. full-matrix oracle (SURVEY.md §4 oracle pattern)."""

import numpy as np
import pytest
import jax.numpy as jnp

from genome_weaver_align.ops import dp, window


def rand_codes(n, seed):
    return np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)


def apply_edits(rng, seq, n_sub, n_ins, n_del):
    s = seq.astype(np.int64).tolist()
    for _ in range(n_del):
        del s[rng.integers(1, len(s) - 1)]
    for _ in range(n_ins):
        s.insert(int(rng.integers(1, len(s) - 1)), int(rng.integers(0, 4)))
    for _ in range(n_sub):
        at = int(rng.integers(0, len(s)))
        s[at] = (s[at] + 1 + int(rng.integers(0, 3))) % 4
    return np.array(s, dtype=np.int64)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_banded_vs_oracle_random(k):
    rng = np.random.default_rng(k)
    Q, L = 32, 30
    W = L + 3 * k
    reads = rng.integers(0, 4, size=(Q, L)).astype(np.int32)
    wins = rng.integers(0, 4, size=(Q, W)).astype(np.int32)
    lengths = np.full(Q, L, np.int32)
    dist, _ = dp.banded_edit_distance(
        jnp.asarray(reads), jnp.asarray(lengths), jnp.asarray(wins), k
    )
    dist = np.asarray(dist)
    for q in range(Q):
        oracle = dp.edit_distance_semiglobal_host(reads[q], wins[q])
        if oracle <= k:
            assert dist[q] == oracle, q
        else:
            # band may only overestimate when true distance exceeds k
            assert dist[q] >= oracle or dist[q] > k


@pytest.mark.parametrize("k,n_sub,n_ins,n_del", [
    (2, 2, 0, 0), (2, 0, 1, 1), (4, 2, 1, 1), (4, 0, 2, 2), (1, 1, 0, 0),
])
def test_banded_planted_edits(k, n_sub, n_ins, n_del):
    rng = np.random.default_rng(13 + k)
    L = 50
    W = L + 3 * k
    genome = rand_codes(4000, 21)
    Q = 24
    reads = np.zeros((Q, L), np.int32)
    wins = np.zeros((Q, W), np.int32)
    true_d = np.zeros(Q, np.int64)
    for q in range(Q):
        pos = int(rng.integers(k, genome.size - L - 4 * k))
        tmpl = genome[pos : pos + L + n_del].astype(np.int64)
        read = apply_edits(rng, tmpl, n_sub, n_ins, n_del)[:L]
        reads[q] = read
        # window starts at cand-k where cand == pos (piece hit at true locus)
        wins[q] = genome[pos - k : pos - k + W]
        true_d[q] = dp.edit_distance_semiglobal_host(read, wins[q])
    dist, _ = dp.banded_edit_distance(
        jnp.asarray(reads), jnp.asarray(np.full(Q, L, np.int32)), jnp.asarray(wins), k
    )
    dist = np.asarray(dist)
    assert np.all(true_d <= n_sub + n_ins + n_del)
    # banded result must equal the oracle whenever the oracle is within k
    sel = true_d <= k
    assert np.array_equal(dist[sel], true_d[sel])


def test_traceback_host():
    rng = np.random.default_rng(3)
    genome = rand_codes(500, 9)
    read = genome[100:150].astype(np.int64).copy()
    # plant 1 sub + 1 del
    read[10] = (read[10] + 1) % 4
    read = np.delete(read, 30)
    win = genome[95:160].astype(np.int64)
    d, start, end, cigar = dp.traceback_semiglobal_host(read, win)
    assert d == 2
    assert start == 5  # read aligns at window offset 5 (= pos 100)
    # CIGAR consumes the whole read: M+I ops sum to len(read)
    import re

    consumed = sum(int(c) for c, op in re.findall(r"(\d+)([MID])", cigar) if op in "MI")
    assert consumed == read.size
    ref_consumed = sum(int(c) for c, op in re.findall(r"(\d+)([MID])", cigar) if op in "MD")
    assert ref_consumed == 50  # one deletion: 49 read bases span 50 ref bases


def test_hamming_device():
    rng = np.random.default_rng(4)
    Q, L, k = 8, 20, 2
    W = L + 3 * k
    wins = rng.integers(0, 4, size=(Q, W)).astype(np.int32)
    reads = np.array([w[k : k + L] for w in wins], dtype=np.int32)
    reads[0, 3] = (reads[0, 3] + 1) % 4
    d = np.asarray(
        dp.hamming_distance(
            jnp.asarray(reads), jnp.asarray(np.full(Q, L, np.int32)), jnp.asarray(wins), k
        )
    )
    assert d[0] == 1 and np.all(d[1:] == 0)


def test_gather_windows():
    from genome_weaver_align.utils import packing

    codes = rand_codes(1000, 5)
    words = jnp.asarray(packing.pack(codes))
    starts = jnp.asarray(np.array([-3, 0, 17, 990], dtype=np.int32))
    w = np.asarray(window.gather_windows(words, 1000, starts, 16))
    assert np.array_equal(w[1], codes[:16])
    assert np.array_equal(w[2], codes[17:33])
    assert np.all(w[0, :3] == 4) and np.array_equal(w[0, 3:], codes[:13])
    assert np.array_equal(w[3, :10], codes[990:]) and np.all(w[3, 10:] == 4)


def test_traceback_banded_batch_matches_full_host():
    """Band traceback (batched) == full-matrix host traceback for mapped
    reads (dist <= k): same dist, start and CIGAR (M>I>D preference)."""
    import numpy as np

    from genome_weaver_align.ops import dp

    rng = np.random.default_rng(42)
    k, L = 4, 80
    W = L + 3 * k
    Q = 150
    wins = rng.integers(0, 4, size=(Q, W)).astype(np.int64)
    reads = np.zeros((Q, L), np.int64)
    for q in range(Q):
        seq = list(wins[q, k : k + L + 6])
        for _ in range(rng.integers(0, 5)):
            t = rng.integers(0, 3)
            p = int(rng.integers(0, len(seq) - 8))
            if t == 0:
                seq[p] = (seq[p] + rng.integers(1, 4)) % 4
            elif t == 1:
                seq.insert(p, int(rng.integers(0, 4)))
            else:
                del seq[p]
        reads[q] = seq[:L]
    lengths = np.full(Q, L, np.int64)
    dist_b, start_b, cig_b = dp.traceback_banded_batch(reads, lengths, wins, k)
    for q in range(Q):
        d, s, _, c = dp.traceback_semiglobal_host(reads[q], wins[q])
        if d <= k:
            assert (int(dist_b[q]), int(start_b[q]), cig_b[q]) == (d, s, c), q
