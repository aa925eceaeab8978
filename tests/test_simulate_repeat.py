"""Vectorised indel simulator + repeat-rich genome generator (bench inputs
must themselves be trustworthy: VERDICT r1 weak-#3)."""

import numpy as np

from genome_weaver_align.ops.dp import edit_distance_semiglobal_host
from genome_weaver_align.utils import dna, simulate


def test_simulate_reads_array_edit_bound():
    g = simulate.random_genome(5000, seed=1)
    reads, pos, strand, has_indel = simulate.simulate_reads_array(
        g, 64, 60, seed=2, max_subs=2, indel_frac=0.5
    )
    for i in range(64):
        r = reads[i].astype(np.int64)
        if strand[i]:
            r = dna.revcomp(reads[i]).astype(np.int64)
        win = g[max(0, pos[i] - 2) : pos[i] + 60 + 4].astype(np.int64)
        d = edit_distance_semiglobal_host(r, win)
        budget = 2 + (1 if has_indel[i] else 0)
        assert d <= budget, (i, d, budget)
    assert has_indel.any() and (~has_indel).any()
    assert (strand == 0).any() and (strand == 1).any()


def test_simulate_reads_array_exact_start():
    g = simulate.random_genome(3000, seed=3)
    reads, pos, strand, has_indel = simulate.simulate_reads_array(
        g, 32, 50, seed=4, max_subs=0, indel_frac=0.0
    )
    for i in range(32):
        r = reads[i] if strand[i] == 0 else dna.revcomp(reads[i])
        assert np.array_equal(r, g[pos[i] : pos[i] + 50])


def test_repeat_genome_structure():
    g = simulate.repeat_genome(200_000, seed=7)
    assert g.size == 200_000 and g.max() <= 3
    # repeat injection must create far more duplicate 13-mers than random DNA
    from genome_weaver_align.index.seedtable import rolling_kmers

    kv = rolling_kmers(g, 13)
    dup_frac = 1.0 - np.unique(kv).size / kv.size
    kv_rand = rolling_kmers(simulate.random_genome(200_000, seed=8), 13)
    dup_rand = 1.0 - np.unique(kv_rand).size / kv_rand.size
    assert dup_frac > 10 * max(dup_rand, 1e-6), (dup_frac, dup_rand)


def test_repeat_genome_aligns_with_overflow_fallback():
    """End-to-end on a repeat-rich genome: everything still maps (possibly to
    another repeat copy) and budget overflow does not silently unmap reads."""
    from genome_weaver_align.index.files import Genome, build_genome_index
    from genome_weaver_align.models.pipeline import SuffixFilterAligner
    from genome_weaver_align.utils.fasta import Contig, Read

    g = simulate.repeat_genome(60_000, seed=11)
    gi = build_genome_index(
        Genome.from_contigs([Contig("rep", g)]), sample_rate=16
    )
    al = SuffixFilterAligner(gi, k=2, max_hits_per_piece=4, max_cands=6)
    reads, pos, strand, _ = simulate.simulate_reads_array(
        g, 48, 100, seed=12, max_subs=2
    )
    rl = [Read(f"q{i}", reads[i].astype(np.uint8)) for i in range(48)]
    hits = al.align_batch(rl)
    n_mapped = sum(h is not None for h in hits)
    assert n_mapped >= 46, n_mapped  # half the loci sit inside repeats
    for h in hits:
        if h is not None:
            assert h.dist <= 2
