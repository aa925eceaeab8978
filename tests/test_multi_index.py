"""Multi-part index: part-split alignment must be bit-identical to a single
index over the concatenated genome."""

import numpy as np
import pytest

from genome_weaver_align.index.files import Genome, build_genome_index
from genome_weaver_align.index.multi import MultiIndexAligner, build_multi_index
from genome_weaver_align.models.pipeline import SuffixFilterAligner
from genome_weaver_align.utils import simulate
from genome_weaver_align.utils.fasta import Contig


def test_multi_part_matches_single():
    rng = np.random.default_rng(81)
    contigs = [
        Contig(f"chr{i}", rng.integers(0, 4, size=sz, dtype=np.uint8))
        for i, sz in enumerate([12000, 9000, 15000, 7000])
    ]
    # force 2+ parts with a small limit
    mi = build_multi_index(contigs, part_limit=25000, sample_rate=16)
    assert len(mi.parts) >= 2

    single = build_genome_index(Genome.from_contigs(contigs), sample_rate=16)
    genome = single.genome
    sims = simulate.simulate_reads(
        genome.codes, 50, 80, seed=6, sub_rate=0.02, max_subs=2
    )
    reads = [s.read for s in sims]

    al_m = MultiIndexAligner(mi, k=2)
    al_s = SuffixFilterAligner(single, k=2)
    hm = al_m.align_batch(reads)
    hs = al_s.align_batch(reads)
    n_same = 0
    for a, b in zip(hm, hs):
        assert (a is None) == (b is None)
        if a is None:
            continue
        # reads whose template crosses a part boundary can differ (the part
        # split truncates the window); everything else must match exactly
        if a.pos == b.pos:
            assert (a.strand, a.dist, a.cigar) == (b.strand, b.dist, b.cigar)
            n_same += 1
    assert n_same >= 45

    recs = al_m.to_sam(reads, hm)
    hdr = al_m.sam_header()
    assert hdr.count("@SQ") == 4
    for rec in recs:
        if not (rec.flag & 0x4):
            assert rec.rname in {c.name for c in contigs}


def test_contig_exceeding_limit_raises():
    rng = np.random.default_rng(1)
    c = Contig("big", rng.integers(0, 4, size=1000, dtype=np.uint8))
    with pytest.raises(ValueError):
        build_multi_index([c], part_limit=500)
