"""SAM output must be byte-identical across batch sizes and verify modes
(the reference-parity bar: deterministic tie-breaking everywhere)."""

import numpy as np
import pytest

from genome_weaver_align.index.files import Genome, build_genome_index
from genome_weaver_align.models.pipeline import SuffixFilterAligner
from genome_weaver_align.utils import simulate
from genome_weaver_align.utils.fasta import Contig


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(91)
    gi = build_genome_index(
        Genome.from_contigs(
            [Contig("chrD", rng.integers(0, 4, size=50000, dtype=np.uint8))]
        ),
        sample_rate=16,
    )
    sims = simulate.simulate_reads(
        gi.genome.codes, 64, 100, seed=7, sub_rate=0.02, max_subs=2
    )
    return gi, [s.read for s in sims]


def sam_lines(al, reads, batch_size):
    out = []
    for i in range(0, len(reads), batch_size):
        batch = reads[i : i + batch_size]
        hits = al.align_batch(batch)
        out.extend(r.line() for r in al.to_sam(batch, hits))
    return out


def test_batch_size_invariance(setup):
    gi, reads = setup
    al = SuffixFilterAligner(gi, k=2)
    full = sam_lines(al, reads, 64)
    assert sam_lines(al, reads, 16) == full
    assert sam_lines(al, reads, 7) == full


def test_verify_mode_invariance(setup):
    gi, reads = setup
    banded = sam_lines(SuffixFilterAligner(gi, k=2), reads, 64)
    myers = sam_lines(SuffixFilterAligner(gi, k=2, verify_mode="myers"), reads, 64)
    assert banded == myers


def test_mixed_length_batch(setup):
    """Non-uniform lengths take the two-pass path; hits must still be found."""
    from genome_weaver_align.utils.fasta import Read

    gi, reads = setup
    mixed = [Read(r.name, r.codes[: 80 + (i % 3) * 7]) for i, r in enumerate(reads)]
    al = SuffixFilterAligner(gi, k=2)
    hits = al.align_batch(mixed)
    assert sum(h is not None for h in hits) >= 58
