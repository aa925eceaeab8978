"""Sharded full pipeline vs. single-device pipeline — identical best hits."""

import numpy as np
import pytest
import jax.numpy as jnp

from genome_weaver_align.index.build import build_fm_index
from genome_weaver_align.models import suffix_filter as sf
from genome_weaver_align.ops import rank
from genome_weaver_align.parallel import mesh as pmesh
from genome_weaver_align.parallel import sharded_index as si
from genome_weaver_align.parallel import sharded_pipeline as sp


@pytest.mark.parametrize("n_data,n_interval", [(1, 2), (2, 2), (1, 4), (4, 2), (2, 4)])
def test_sharded_pipeline_matches_single(n_data, n_interval):
    rng = np.random.default_rng(71)
    codes = rng.integers(0, 4, size=20000, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=16)
    k, L = 2, 60
    B = 8 * n_data
    reads = np.zeros((B, L), dtype=np.int32)
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        r = codes[p : p + L].astype(np.int32).copy()
        for _ in range(int(rng.integers(0, k + 1))):
            at = int(rng.integers(0, L))
            r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        reads[i] = r
    lengths = np.full(B, L, np.int32)

    m = pmesh.make_mesh(n_data=n_data, n_interval=n_interval)
    sh = si.put_sharded(si.shard_fm_index(fm, n_interval), m, pmesh.INTERVAL_AXIS)
    tx = sp.put_text(
        sp.shard_text(fm.text_words, fm.n, n_interval), m, pmesh.INTERVAL_AXIS
    )
    fn = sp.make_sharded_pigeonhole_align(
        m,
        pmesh.INTERVAL_AXIS,
        pmesh.DATA_AXIS,
        like_index=sh,
        like_text=tx,
        max_len=L,
        k=k,
        max_hits=8,
    )
    r, l, _ = pmesh.shard_reads(m, reads, lengths)
    bp, bd, ng, ovf = (np.asarray(x) for x in fn(sh, tx, r, l))

    # single-device reference
    dfm = rank.from_host(fm)
    cands = sf.pigeonhole_candidates(
        dfm, jnp.asarray(reads), jnp.asarray(lengths), k + 1, 8
    )
    dist, _ = sf.verify_candidates(
        jnp.asarray(fm.text_words),
        fm.n,
        jnp.asarray(reads),
        jnp.asarray(lengths),
        cands.cand_pos,
        k,
        L + 3 * k,
    )
    best = sf.best_hit(cands.cand_pos, dist, k)
    assert np.array_equal(bp, np.asarray(best.best_pos))
    assert np.array_equal(bd, np.asarray(best.best_dist))
    assert np.array_equal(ng, np.asarray(best.n_good))


def test_sharded_aligner_matches_single_device():
    from genome_weaver_align.index.files import Genome, build_genome_index
    from genome_weaver_align.models.pipeline import SuffixFilterAligner
    from genome_weaver_align.parallel.sharded_pipeline import ShardedAligner
    from genome_weaver_align.utils import simulate
    from genome_weaver_align.utils.fasta import Contig

    rng = np.random.default_rng(31)
    gi = build_genome_index(
        Genome.from_contigs(
            [Contig("cS", rng.integers(0, 4, size=30000, dtype=np.uint8))]
        ),
        sample_rate=16,
    )
    sims = simulate.simulate_reads(
        gi.genome.codes, 32, 80, seed=4, sub_rate=0.02, max_subs=2
    )
    reads = [s.read for s in sims]
    single = SuffixFilterAligner(gi, k=2).align_batch(reads)
    sharded = ShardedAligner(gi, k=2, n_interval=4).align_batch(reads)
    for a, b in zip(single, sharded):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.pos, a.strand, a.dist, a.cigar) == (b.pos, b.strand, b.dist, b.cigar)


@pytest.mark.parametrize("n_data,n_interval", [(1, 2), (2, 2), (1, 4), (4, 2), (2, 4)])
def test_sharded_seed_pipeline_matches_single(n_data, n_interval):
    """Seed-sharded align (k-mer-range shards, one candidate psum) ==
    single-device seed path best hits."""
    from genome_weaver_align.index import seedtable

    rng = np.random.default_rng(91)
    codes = rng.integers(0, 4, size=30000, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=16)
    j, k, L = 8, 2, 90
    offsets, positions = seedtable.build_seed_table(codes, j)
    B = 8 * n_data
    reads = np.zeros((B, L), dtype=np.int32)
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        r = codes[p : p + L].astype(np.int32).copy()
        for _ in range(int(rng.integers(0, k + 1))):
            at = int(rng.integers(0, L))
            r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        reads[i] = r
    lengths = np.full(B, L, np.int32)

    m = pmesh.make_mesh(n_data=n_data, n_interval=n_interval)
    sst = sp.put_seed(
        sp.shard_seed_table(offsets, positions, j, n_interval), m, pmesh.INTERVAL_AXIS
    )
    tx = sp.put_text(
        sp.shard_text(fm.text_words, fm.n, n_interval), m, pmesh.INTERVAL_AXIS
    )
    fn = sp.make_sharded_seed_align(
        m, pmesh.INTERVAL_AXIS, pmesh.DATA_AXIS,
        like_seed=sst, like_text=tx, max_len=L, k=k, max_hits=16,
    )
    r, l, _ = pmesh.shard_reads(m, reads, lengths)
    bp, bd, ng, ovf = (np.asarray(x) for x in fn(sst, tx, r, l))

    cands = sf.seed_candidates(
        jnp.asarray(offsets), jnp.asarray(positions),
        jnp.asarray(reads), jnp.asarray(lengths), k + 1, j, max_hits=16,
    )
    dist, _ = sf.verify_candidates(
        jnp.asarray(fm.text_words), fm.n, jnp.asarray(reads),
        jnp.asarray(lengths), cands.cand_pos, k, L + 3 * k,
    )
    best = sf.best_hit(cands.cand_pos, dist, k)
    assert np.array_equal(bp[:B], np.asarray(best.best_pos))
    assert np.array_equal(bd[:B], np.asarray(best.best_dist))
    assert np.array_equal(ng[:B], np.asarray(best.n_good))
    assert np.array_equal(ovf[:B], np.asarray(cands.overflow))


def test_sharded_aligner_seed_sam_identity():
    """ShardedAligner with a seed table == single-device seeded aligner SAM."""
    from genome_weaver_align.index import seedtable
    from genome_weaver_align.index.files import Genome, build_genome_index
    from genome_weaver_align.models.pipeline import SuffixFilterAligner
    from genome_weaver_align.utils import simulate
    from genome_weaver_align.utils.fasta import Contig

    rng = np.random.default_rng(13)
    genome = Genome.from_contigs(
        [Contig("chrS", rng.integers(0, 4, size=40000, dtype=np.uint8))]
    )
    gi = build_genome_index(genome, sample_rate=16)
    j = 8
    offsets, positions = seedtable.build_seed_table(genome.codes, j)
    sims = simulate.simulate_reads(
        genome.codes, n_reads=48, read_len=100, seed=5, sub_rate=0.02, max_subs=2
    )
    reads = [s.read for s in sims]

    single = SuffixFilterAligner(
        gi, k=2, max_hits_per_piece=16, seed_table=(offsets, positions), seed_j=j
    )
    sharded = sp.ShardedAligner(
        gi, k=2, n_interval=4, max_hits=16, seed_table=(offsets, positions), seed_j=j
    )
    recs_a = [r.line() for r in single.to_sam(reads, single.align_batch(reads))]
    recs_b = [r.line() for r in sharded.to_sam(reads, sharded.align_batch(reads))]
    assert recs_a == recs_b


def test_sharded_aligner_mixed_length_seed_gating():
    """Mixed-length batches must gate the seed path on the SHORTEST read
    (ADVICE r1 high: batch-max gating silently unmapped short reads whose
    last-j-mers crossed piece boundaries), and all-short batches must fall
    back to the FM shards instead of crashing."""
    from genome_weaver_align.index import seedtable
    from genome_weaver_align.index.files import Genome, build_genome_index
    from genome_weaver_align.models.pipeline import SuffixFilterAligner
    from genome_weaver_align.utils.fasta import Contig, Read

    rng = np.random.default_rng(77)
    genome = Genome.from_contigs(
        [Contig("chrM", rng.integers(0, 4, size=20000, dtype=np.uint8))]
    )
    gi = build_genome_index(genome, sample_rate=16)
    j, k = 8, 2
    offsets, positions = seedtable.build_seed_table(genome.codes, j)

    def make_read(name, L, n_sub):
        p = int(rng.integers(0, genome.codes.size - L))
        r = genome.codes[p : p + L].astype(np.uint8).copy()
        for _ in range(n_sub):
            at = int(rng.integers(0, L))
            r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        return Read(name, r, None), p

    mixed, true_pos = [], []
    for i in range(8):
        rd, p = make_read(f"short{i}", 20, 2)
        mixed.append(rd)
        true_pos.append(p)
    for i in range(8):
        rd, p = make_read(f"long{i}", 100, 2)
        mixed.append(rd)
        true_pos.append(p)

    single = SuffixFilterAligner(
        gi, k=k, max_hits_per_piece=16, seed_table=(offsets, positions), seed_j=j
    )
    sharded = sp.ShardedAligner(
        gi, k=k, n_interval=2, max_hits=16, seed_table=(offsets, positions), seed_j=j
    )
    hs = single.align_batch(mixed)
    hd = sharded.align_batch(mixed)
    for a, b in zip(hs, hd):
        assert (a is None) == (b is None)
        if a is not None:
            assert (a.pos, a.strand, a.dist) == (b.pos, b.strand, b.dist)
    # the short reads specifically must not be silently unmapped
    n_short_mapped = sum(1 for h in hd[:8] if h is not None)
    assert n_short_mapped == sum(1 for h in hs[:8] if h is not None)

    # all-short batch: uses the FM fallback path, must not raise
    shorts = mixed[:8]
    hd2 = sharded.align_batch(shorts)
    assert [h is not None for h in hd2] == [h is not None for h in hd[:8]]
