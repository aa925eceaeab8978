"""Paired-end alignment: proper-pair classification, SAM pair fields,
mate rescue of an unmappable mate via the insert window."""

import numpy as np
import pytest

from genome_weaver_align.index.files import Genome, build_genome_index
from genome_weaver_align.models.paired import PairedAligner
from genome_weaver_align.models.pipeline import SuffixFilterAligner
from genome_weaver_align.utils import simulate
from genome_weaver_align.utils.fasta import Contig, Read


@pytest.fixture(scope="module")
def gi():
    rng = np.random.default_rng(61)
    return build_genome_index(
        Genome.from_contigs(
            [Contig("chrP", rng.integers(0, 4, size=60000, dtype=np.uint8))]
        ),
        sample_rate=16,
    )


def test_proper_pairs(gi):
    sims = simulate.simulate_pairs(
        gi.genome.codes, 30, 100, seed=4, sub_rate=0.01, max_subs=2
    )
    al = PairedAligner(SuffixFilterAligner(gi, k=2))
    pairs = [(s.r1.read, s.r2.read) for s in sims]
    hits = al.align_pairs(pairs)
    n_proper = 0
    for s, ph in zip(sims, hits):
        assert ph.h1 is not None and ph.h2 is not None
        if ph.h1.n_good == 1 and ph.h2.n_good == 1:
            assert ph.h1.pos == s.r1.true_pos
            assert ph.h2.pos == s.r2.true_pos
            assert ph.proper
            n_proper += 1
    assert n_proper >= 25

    recs = al.to_sam(pairs, hits)
    assert len(recs) == 60
    for i in range(0, 60, 2):
        r1, r2 = recs[i], recs[i + 1]
        assert r1.qname == r2.qname
        assert (r1.flag & 0x40) and (r2.flag & 0x80)
        if r1.flag & 0x2:
            assert r1.rnext == "=" and r2.rnext == "="
            assert r1.pnext == r2.pos and r2.pnext == r1.pos
            assert r1.tlen == -r2.tlen and abs(r1.tlen) >= 200
            f = r1.line().split("\t")
            assert f[6] == "=" and int(f[8]) == r1.tlen


def test_mate_rescue(gi):
    sims = simulate.simulate_pairs(gi.genome.codes, 8, 100, seed=9)
    pairs = []
    for s in sims:
        # corrupt R2 beyond k=2 so single-end alignment fails, rescue succeeds
        c = s.r2.read.codes.copy()
        for at in (10, 30, 50, 70):
            c[at] = (c[at] + 1) % 4
        pairs.append((s.r1.read, Read(s.r2.read.name, c)))
    al = PairedAligner(SuffixFilterAligner(gi, k=2), rescue=True)
    hits = al.align_pairs(pairs)
    n_rescued = 0
    for s, ph in zip(sims, hits):
        assert ph.h1 is not None
        if ph.rescued == 2:
            n_rescued += 1
            assert ph.h2 is not None
            assert ph.h2.pos == s.r2.true_pos
            assert ph.h2.dist == 4
    assert n_rescued >= 6


def test_half_mapped_flags(gi):
    rng = np.random.default_rng(5)
    sims = simulate.simulate_pairs(gi.genome.codes, 3, 100, seed=12)
    pairs = [
        (s.r1.read, Read("junk", rng.integers(0, 4, size=100, dtype=np.uint8)))
        for s in sims
    ]
    al = PairedAligner(SuffixFilterAligner(gi, k=2), rescue=False)
    hits = al.align_pairs(pairs)
    recs = al.to_sam(pairs, hits)
    for i in range(0, len(recs), 2):
        r1, r2 = recs[i], recs[i + 1]
        assert not (r1.flag & 0x4)
        assert r2.flag & 0x4
        assert r1.flag & 0x8  # mate unmapped
        assert not (r1.flag & 0x2)


def test_paired_over_list_api_aligners(gi):
    """PairedAligner must work over aligners WITHOUT the array API —
    ShardedAligner and OneMismatchAligner only expose align_batch
    (regression: align_pairs once hard-required align_arrays_submit and
    crashed for `align --paired --n-interval 2` / `--mode onemm`)."""
    from genome_weaver_align.models.one_mismatch import OneMismatchAligner
    from genome_weaver_align.parallel.sharded_pipeline import ShardedAligner

    sims = simulate.simulate_pairs(
        gi.genome.codes, 12, 80, seed=9, sub_rate=0.005, max_subs=1
    )
    pairs = [(s.r1.read, s.r2.read) for s in sims]
    for mk in (
        lambda: ShardedAligner(gi, k=2, n_interval=2),
        lambda: OneMismatchAligner(gi),
    ):
        al = PairedAligner(mk(), rescue=True)
        hits = al.align_pairs(pairs)
        n_proper = sum(ph.proper for ph in hits)
        assert n_proper >= 10, type(al.al).__name__
        recs = al.to_sam(pairs, hits)
        assert len(recs) == 2 * len(pairs)
