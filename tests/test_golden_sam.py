"""Golden SAM pin (SURVEY.md §4): the full pipeline's SAM bytes on a fixed
synthetic dataset are committed; any change to search, verify, tie-breaking,
CIGAR or SAM formatting must be deliberate (regenerate with
``python tests/test_golden_sam.py``)."""

from pathlib import Path

import numpy as np

from genome_weaver_align.index.files import Genome, build_genome_index
from genome_weaver_align.models.paired import PairedAligner
from genome_weaver_align.models.pipeline import SuffixFilterAligner
from genome_weaver_align.utils import simulate
from genome_weaver_align.utils.fasta import Contig, Read

GOLDEN = Path(__file__).parent / "data" / "golden.sam"


def build_output() -> str:
    rng = np.random.default_rng(2026)
    gi = build_genome_index(
        Genome.from_contigs(
            [
                Contig("gA", rng.integers(0, 4, size=30000, dtype=np.uint8)),
                Contig("gB", rng.integers(0, 4, size=20000, dtype=np.uint8)),
            ]
        ),
        sample_rate=16,
    )
    al = SuffixFilterAligner(gi, k=4)

    sims = simulate.simulate_reads(
        gi.genome.codes, 24, 100, seed=11, sub_rate=0.02, max_subs=2,
        indel_rate=0.01, max_indels=2,
    )
    reads = [s.read for s in sims]
    # edge cases: N-containing read, unmappable read
    nr = reads[0].codes.copy()
    nr[10:13] = 4
    reads.append(Read("with_n", nr))
    reads.append(Read("junk", rng.integers(0, 4, size=100, dtype=np.uint8)))
    hits = al.align_batch(reads)
    lines = [al.sam_header()]
    lines += [r.line() for r in al.to_sam(reads, hits)]

    # paired block
    pal = PairedAligner(al)
    pairs = [
        (p.r1.read, p.r2.read)
        for p in simulate.simulate_pairs(gi.genome.codes, 6, 100, seed=12, sub_rate=0.01, max_subs=1)
    ]
    phits = pal.align_pairs(pairs)
    lines += [r.line() for r in pal.to_sam(pairs, phits)]
    return "\n".join(lines) + "\n"


def test_golden_sam():
    assert GOLDEN.exists(), "golden missing — run this file directly to generate"
    assert build_output() == GOLDEN.read_text()


if __name__ == "__main__":
    GOLDEN.parent.mkdir(exist_ok=True)
    GOLDEN.write_text(build_output())
    print(f"wrote {GOLDEN}")
