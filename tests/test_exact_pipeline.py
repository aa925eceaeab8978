"""End-to-end acceptance config 1: exact-match align on a tiny genome
(SURVEY.md §4 integration-test pattern: simulated reads map to true loci)."""

import numpy as np

from genome_weaver_align.index.files import Genome, build_genome_index, load_index, save_index
from genome_weaver_align.models.pipeline import ExactAligner
from genome_weaver_align.utils import simulate
from genome_weaver_align.utils.fasta import Contig


def make_index(n=20000, seed=0, contigs=2):
    rng = np.random.default_rng(seed)
    sizes = [n // contigs] * contigs
    cs = [
        Contig(f"chr{i}", rng.integers(0, 4, size=s, dtype=np.uint8))
        for i, s in enumerate(sizes)
    ]
    genome = Genome.from_contigs(cs)
    return build_genome_index(genome, sample_rate=16)


def test_exact_align_end_to_end(tmp_path):
    gi = make_index()
    sims = simulate.simulate_reads(gi.genome.codes, n_reads=100, read_len=36, seed=3)
    aligner = ExactAligner(gi)
    reads = [s.read for s in sims]
    hits = aligner.align_batch(reads)
    n_checked = 0
    for s, h in zip(sims, hits):
        assert h is not None, s.read.name
        # best hit is the minimal matching position; the true locus must be a hit
        if h.n_hits == 1:
            assert h.pos == s.true_pos and h.strand == s.true_strand
            n_checked += 1
    assert n_checked >= 90  # random 36-mers are almost surely unique

    recs = aligner.to_sam(reads, hits)
    sam_path = tmp_path / "out.sam"
    from genome_weaver_align.utils.sam import write_sam

    write_sam(sam_path, aligner.sam_header(), recs)
    lines = sam_path.read_text().splitlines()
    assert lines[0].startswith("@HD")
    body = [l for l in lines if not l.startswith("@")]
    assert len(body) == 100
    # SAM positions are 1-based within the contig
    for s, rec in zip(sims, body):
        f = rec.split("\t")
        assert f[0] == s.read.name
        if int(f[1]) & 0x4:
            continue
        ci, local = gi.genome.coord(s.true_pos)
        if f[2] == gi.genome.names[int(ci[0])]:
            assert int(f[3]) - 1 in range(0, gi.genome.n)


def test_index_save_load_roundtrip(tmp_path):
    gi = make_index(n=4000, contigs=1)
    p = tmp_path / "idx.npz"
    save_index(p, gi)
    gi2 = load_index(p)
    assert gi2.genome.names == gi.genome.names
    assert np.array_equal(gi2.fwd.bwt_words, gi.fwd.bwt_words)
    assert np.array_equal(gi2.fwd.occ_cp, gi.fwd.occ_cp)
    assert gi2.fwd.primary == gi.fwd.primary
    # search works identically after reload
    pat = gi.genome.codes[1234:1264]
    assert gi2.fwd.backward_search(pat) == gi.fwd.backward_search(pat)
    assert np.array_equal(gi2.rev.bwt_words, gi.rev.bwt_words)


def test_unmapped_read():
    gi = make_index(n=2000, contigs=1)
    # a read absent from the genome (with high probability)
    rng = np.random.default_rng(99)
    from genome_weaver_align.utils.fasta import Read

    r = Read("noexist", rng.integers(0, 4, size=36, dtype=np.uint8))
    aligner = ExactAligner(gi)
    hits = aligner.align_batch([r])
    if hits[0] is not None:  # astronomically unlikely
        assert hits[0].n_hits >= 1
    recs = aligner.to_sam([r], hits)
    assert recs[0].flag & 0x4 or hits[0] is not None


def test_genome_with_n_regions():
    """N runs in the input genome are randomized deterministically and
    recorded as spans; reads over clean regions still align exactly."""
    rng = np.random.default_rng(13)
    codes = rng.integers(0, 4, size=8000, dtype=np.uint8)
    raw = codes.copy()
    raw[2000:2100] = 4  # N run
    from genome_weaver_align.index.files import Genome, build_genome_index
    from genome_weaver_align.utils.fasta import Contig, Read
    from genome_weaver_align.models.pipeline import SuffixFilterAligner

    g = Genome.from_contigs([Contig("n1", raw)])
    assert g.n_mask_spans.shape == (1, 2)
    assert tuple(g.n_mask_spans[0]) == (2000, 2100)
    assert g.codes.max() <= 3
    gi = build_genome_index(g, sample_rate=16)
    al = SuffixFilterAligner(gi, k=2)
    # a clean-region read and a read with its own N
    r1 = Read("clean", g.codes[5000:5100].copy())
    rn = g.codes[6000:6100].copy()
    rn[50] = 4
    r2 = Read("hasN", rn)
    h1, h2 = al.align_batch([r1, r2])
    assert h1 is not None and h1.pos == 5000 and h1.dist == 0
    assert h2 is not None and h2.pos == 6000 and h2.dist == 1  # N costs one edit
