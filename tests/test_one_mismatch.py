"""1-mismatch bidirectional search (config 2): exact recall + no false
positives vs. a brute-force Hamming scan."""

import numpy as np
import pytest
import jax.numpy as jnp

from genome_weaver_align.index.build import build_fm_index
from genome_weaver_align.models import bidirectional as bd
from genome_weaver_align.models import exact, one_mismatch
from genome_weaver_align.ops import rank


@pytest.fixture(scope="module")
def setup():
    codes = np.random.default_rng(11).integers(0, 4, size=30000, dtype=np.uint8)
    fwd = build_fm_index(codes, sample_rate=16)
    rev = build_fm_index(codes[::-1].copy(), sample_rate=16)
    return codes, fwd, rev, bd.from_host_bi(fwd, rev)


def brute_hits(codes, read, maxmm=1):
    n, m = codes.size, read.size
    wins = np.lib.stride_tricks.sliding_window_view(codes, m)
    mm = (wins != read[None, :]).sum(axis=1)
    return {int(p): int(d) for p, d in enumerate(mm) if d <= maxmm}


def collect_positions(fm_host, dfm, cand_lo, cand_hi, max_hits=8):
    B, C = cand_lo.shape
    lo = jnp.asarray(cand_lo.reshape(-1))
    hi = jnp.asarray(cand_hi.reshape(-1))
    pos, valid = exact.locate_hits(dfm, lo, hi, max_hits)
    pos = np.asarray(pos).reshape(B, C * max_hits)
    valid = np.asarray(valid).reshape(B, C * max_hits)
    return [set(pos[i][valid[i]].tolist()) for i in range(B)]


def test_one_mismatch_recall_and_precision(setup):
    codes, fwd, rev, bi = setup
    rng = np.random.default_rng(5)
    B, L = 48, 40
    reads = np.zeros((B, L), dtype=np.int32)
    planted = []
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        r = codes[p : p + L].astype(np.int32).copy()
        nmm = int(rng.integers(0, 2))
        for _ in range(nmm):
            at = int(rng.integers(0, L))
            r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        reads[i] = r
        planted.append((p, nmm))
    lengths = np.full(B, L, dtype=np.int32)

    cand_lo, cand_hi, ovf = one_mismatch.one_mismatch_candidates(
        bi, jnp.asarray(reads), jnp.asarray(lengths)
    )
    cand_lo, cand_hi = np.asarray(cand_lo), np.asarray(cand_hi)
    assert not np.asarray(ovf).any(), "slot overflow on random genome"

    dfm = rank.from_host(fwd)
    got_sets = collect_positions(fwd, dfm, cand_lo, cand_hi)
    for i in range(B):
        want = set(brute_hits(codes, reads[i]).keys())
        assert got_sets[i] == want, f"read {i} planted={planted[i]}"
        assert planted[i][0] in got_sets[i]


def test_one_mismatch_variable_lengths(setup):
    codes, fwd, rev, bi = setup
    rng = np.random.default_rng(9)
    B, L = 16, 36
    reads = np.zeros((B, L), dtype=np.int32)
    lengths = rng.integers(20, L + 1, size=B).astype(np.int32)
    for i in range(B):
        l = int(lengths[i])
        p = int(rng.integers(0, codes.size - l))
        r = codes[p : p + l].astype(np.int32).copy()
        at = int(rng.integers(0, l))
        r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        reads[i, :l] = r
    cand_lo, cand_hi, ovf = one_mismatch.one_mismatch_candidates(
        bi, jnp.asarray(reads), jnp.asarray(lengths)
    )
    dfm = rank.from_host(fwd)
    got = collect_positions(fwd, dfm, np.asarray(cand_lo), np.asarray(cand_hi))
    for i in range(B):
        l = int(lengths[i])
        want = set(brute_hits(codes, reads[i, :l]).keys())
        assert got[i] == want, f"read {i} len={l}"


def test_one_mismatch_aligner_end_to_end():
    from genome_weaver_align.index.files import Genome, build_genome_index
    from genome_weaver_align.models.one_mismatch import OneMismatchAligner
    from genome_weaver_align.utils import simulate
    from genome_weaver_align.utils.fasta import Contig

    rng = np.random.default_rng(19)
    gi = build_genome_index(
        Genome.from_contigs(
            [Contig("c", rng.integers(0, 4, size=40000, dtype=np.uint8))]
        ),
        sample_rate=16,
    )
    sims = simulate.simulate_reads(
        gi.genome.codes, 30, 100, seed=4, sub_rate=0.005, max_subs=1
    )
    al = OneMismatchAligner(gi)
    hits = al.align_batch([s.read for s in sims])
    for s, h in zip(sims, hits):
        assert h is not None, s.read.name
        assert h.dist == s.n_sub
        # best = smallest locus; unique reads must land on the true one
        assert h.pos == s.true_pos or h.dist == 0
        if h.pos == s.true_pos:
            assert h.strand == s.true_strand
    recs = al.to_sam([s.read for s in sims], hits)
    assert len(recs) == 30 and all(not (r.flag & 0x4) for r in recs)
