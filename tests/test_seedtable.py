"""CSR seed table (index.seedtable) and full-SA locate: oracle equality and
end-to-end identity with the FM candidate path (SURVEY.md §4 oracle pattern)."""

import numpy as np
import pytest

from genome_weaver_align.index import seedtable
from genome_weaver_align.index.build import build_fm_index
from genome_weaver_align.index.files import Genome, build_genome_index
from genome_weaver_align.models.pipeline import SuffixFilterAligner
from genome_weaver_align.utils import simulate
from genome_weaver_align.utils.fasta import Contig


def test_rolling_kmers_oracle():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=500, dtype=np.uint8)
    j = 5
    kv = seedtable.rolling_kmers(codes, j)
    for i in range(0, codes.size - j + 1, 17):
        want = 0
        for t in range(j):
            want = (want << 2) | int(codes[i + t])
        assert kv[i] == want


def test_seed_table_buckets_are_sorted_positions():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=3000, dtype=np.uint8)
    j = 4
    offsets, positions = seedtable.build_seed_table(codes, j)
    kv = seedtable.rolling_kmers(codes, j)
    for km in rng.integers(0, 4**j, size=40):
        got = positions[offsets[km] : offsets[km + 1]]
        want = np.nonzero(kv == km)[0]
        assert np.array_equal(got, want)  # ascending by construction


def test_seed_table_native_equals_numpy():
    """C++ counting-sort builder (native/seedtable.cpp) vs the NumPy argsort
    oracle: identical offsets AND positions (stable, position-ascending)."""
    from genome_weaver_align.index import native

    if not native.available():
        pytest.skip("native library unavailable")
    rng = np.random.default_rng(5)
    for n, j in ((3000, 4), (50_000, 7), (257, 3)):
        codes = rng.integers(0, 4, size=n, dtype=np.uint8)
        no, npos = native.seed_table_native(codes, j)
        oo, opos = seedtable.build_seed_table_numpy(codes, j)
        assert np.array_equal(no, oo), (n, j)
        assert np.array_equal(npos, opos), (n, j)


def test_seed_candidates_superset_of_pigeonhole():
    """Every diagonal the exact-piece FM path proposes is proposed by the
    seed path too (before the max_cands cap)."""
    import jax.numpy as jnp

    from genome_weaver_align.models import suffix_filter
    from genome_weaver_align.ops import rank

    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=20000, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=8)
    dfm = rank.from_host(fm)
    j = 8
    offsets, positions = seedtable.build_seed_table(codes, j)

    sims = simulate.simulate_reads(
        codes, n_reads=40, read_len=60, seed=3, sub_rate=0.02, max_subs=2
    )
    reads = np.stack([s.read.codes for s in sims]).astype(np.int32)
    lengths = np.full(len(sims), 60, dtype=np.int32)

    fmc = suffix_filter.pigeonhole_candidates(
        dfm, jnp.asarray(reads), jnp.asarray(lengths), 3, max_hits=16
    )
    sdc = suffix_filter.seed_candidates(
        jnp.asarray(offsets), jnp.asarray(positions),
        jnp.asarray(reads), jnp.asarray(lengths), 3, j, max_hits=32,
    )
    NO = int(suffix_filter.NO_CAND)
    for b in range(len(sims)):
        if bool(sdc.overflow[b]) or bool(fmc.overflow[b]):
            continue
        fm_set = {int(c) for c in np.asarray(fmc.cand_pos[b]) if c != NO}
        sd_set = {int(c) for c in np.asarray(sdc.cand_pos[b]) if c != NO}
        assert fm_set <= sd_set, (b, fm_set - sd_set)


@pytest.fixture(scope="module")
def gi():
    rng = np.random.default_rng(7)
    genome = Genome.from_contigs(
        [Contig("chrT", rng.integers(0, 4, size=60000, dtype=np.uint8))]
    )
    return build_genome_index(genome, sample_rate=16, keep_full_sa=True)


def test_pipeline_seeded_identical_to_fm(gi):
    j = 8
    offsets, positions = seedtable.build_seed_table(gi.genome.codes, j)
    sims = simulate.simulate_reads(
        gi.genome.codes, n_reads=80, read_len=100, seed=9,
        sub_rate=0.02, max_subs=2,
    )
    reads = [s.read for s in sims]
    plain = SuffixFilterAligner(gi, k=2).align_batch(reads)
    seeded = SuffixFilterAligner(
        gi, k=2, seed_table=(offsets, positions), seed_j=j
    ).align_batch(reads)
    for a, b in zip(plain, seeded):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.pos, a.strand, a.dist, a.cigar) == (b.pos, b.strand, b.dist, b.cigar)


def test_pipeline_seeded_indels(gi):
    j = 8
    offsets, positions = seedtable.build_seed_table(gi.genome.codes, j)
    sims = simulate.simulate_reads(
        gi.genome.codes, n_reads=40, read_len=150, seed=10,
        sub_rate=0.01, max_subs=2, indel_rate=0.01, max_indels=2,
    )
    reads = [s.read for s in sims]
    al = SuffixFilterAligner(gi, k=4, seed_table=(offsets, positions), seed_j=j)
    hits = al.align_batch(reads)
    for s, h in zip(sims, hits):
        assert h is not None, s.read.name
        assert h.dist <= s.n_sub + s.n_ins + s.n_del


def test_full_sa_locate_identity(gi):
    """Full-SA locate returns exactly the LF-walk locate's positions."""
    import jax.numpy as jnp

    from genome_weaver_align.ops import rank

    fm_fast = rank.from_host(gi.fwd)
    assert fm_fast.full_sa is not None
    import dataclasses

    fm_slow = dataclasses.replace(fm_fast, full_sa=None)
    rng = np.random.default_rng(11)
    rows = jnp.asarray(rng.integers(0, gi.fwd.n + 1, size=512, dtype=np.int32))
    fast = np.asarray(rank.locate(fm_fast, rows))
    slow = np.asarray(rank.locate(fm_slow, rows))
    assert np.array_equal(fast, slow)
    assert np.array_equal(fast, np.asarray(gi.fwd.full_sa)[np.asarray(rows)])


def test_full_sa_exact_aligner_identity(gi):
    from genome_weaver_align.models.pipeline import ExactAligner

    sims = simulate.simulate_reads(
        gi.genome.codes, n_reads=50, read_len=36, seed=12, sub_rate=0.0
    )
    reads = [s.read for s in sims]
    hits = ExactAligner(gi).align_batch(reads)
    for s, h in zip(sims, hits):
        assert h is not None
        if h.n_hits == 1:
            assert h.pos == s.true_pos and h.strand == s.true_strand


def test_compact_verify_identity(gi):
    """Batch-compacted verify + scatter-min best == per-read verify + argmin
    best on the same candidates (budget not exceeded)."""
    import jax.numpy as jnp

    from genome_weaver_align.models import suffix_filter
    from genome_weaver_align.ops import rank

    dfm = rank.from_host(gi.fwd)
    text_words = jnp.asarray(gi.fwd.text_words)
    sims = simulate.simulate_reads(
        gi.genome.codes, n_reads=64, read_len=100, seed=21, sub_rate=0.02, max_subs=2
    )
    reads = np.stack([s.read.codes for s in sims]).astype(np.int32)
    lengths = np.full(len(sims), 100, np.int32)
    k, W = 2, 106
    cands = suffix_filter.pigeonhole_candidates(
        dfm, jnp.asarray(reads), jnp.asarray(lengths), 3, max_hits=8, max_cands=8
    )
    dist, _ = suffix_filter.verify_candidates(
        text_words, gi.fwd.n, jnp.asarray(reads), jnp.asarray(lengths),
        cands.cand_pos, k, W,
    )
    plain = suffix_filter.best_hit(cands.cand_pos, dist, k)
    dist_c, cp_c, rid_c, ovf2 = suffix_filter.verify_candidates_compact(
        text_words, gi.fwd.n, jnp.asarray(reads), jnp.asarray(lengths),
        cands.cand_pos, k, W, slack=6,
    )
    comp = suffix_filter.best_hit_compact(rid_c, cp_c, dist_c, k, len(sims))
    assert not bool(np.asarray(ovf2).any())
    assert np.array_equal(np.asarray(plain.best_pos), np.asarray(comp.best_pos))
    assert np.array_equal(np.asarray(plain.best_dist), np.asarray(comp.best_dist))
    assert np.array_equal(np.asarray(plain.n_good), np.asarray(comp.n_good))


def test_compact_verify_budget_overflow_flag(gi):
    """Exceeding the pooled budget flags overflow (never silent)."""
    import jax.numpy as jnp

    from genome_weaver_align.models import suffix_filter

    text_words = jnp.asarray(gi.fwd.text_words)
    B, C = 8, 8
    # all reads fully loaded with candidates; slack=2 -> budget 16 < 64
    cand = jnp.tile(jnp.arange(C, dtype=jnp.int32)[None, :] * 64, (B, 1))
    reads = jnp.zeros((B, 50), jnp.int32)
    lengths = jnp.full((B,), 50, jnp.int32)
    _, _, _, ovf = suffix_filter.verify_candidates_compact(
        text_words, gi.fwd.n, reads, lengths, cand, 2, 56, slack=2,
    )
    ovf = np.asarray(ovf)
    assert ovf.any() and not ovf[:2].any()  # first reads fit, later overflow
