"""Boundary fuzz: tiny genomes around packing/block edges (n near 16/128
multiples) — full pipeline vs brute-force Hamming scan.  These sizes stress
the sentinel shift, partial-block masks, and checkpoint edges that larger
random tests rarely hit."""

import numpy as np
import pytest

from genome_weaver_align.index.files import Genome, GenomeIndex
from genome_weaver_align.index.build import build_fm_index
from genome_weaver_align.models.pipeline import SuffixFilterAligner
from genome_weaver_align.utils.fasta import Read


def brute_best(codes, read, k):
    """(dist, pos, strand) by the pipeline's deterministic order, or None."""
    best = None
    for strand, r in ((0, read), (1, (3 - read)[::-1])):
        if codes.size < r.size:
            continue
        wins = np.lib.stride_tricks.sliding_window_view(codes, r.size)
        mm = (wins != r[None, :]).sum(axis=1)
        for p in np.nonzero(mm <= k)[0]:
            key = (int(mm[p]), int(p), strand)
            if best is None or key < best:
                best = key
    return best


@pytest.mark.parametrize("n", [127, 128, 129, 255, 257, 300, 1000])
@pytest.mark.parametrize("seed", [0, 1])
def test_pipeline_vs_brute_small(n, seed):
    rng = np.random.default_rng(n * 100 + seed)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=4)
    genome = Genome(
        names=["t"],
        offsets=np.array([0, n], np.int64),
        codes=codes,
        n_mask_spans=np.zeros((0, 2), np.int64),
    )
    al = SuffixFilterAligner(GenomeIndex(genome, fm, None), k=2, max_hits_per_piece=16)
    L = min(30, n // 3)
    reads = []
    expect = []
    for i in range(20):
        p = int(rng.integers(0, n - L))
        r = codes[p : p + L].astype(np.int64).copy()
        for _ in range(int(rng.integers(0, 3))):
            at = int(rng.integers(0, L))
            r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        if rng.integers(0, 2):
            r = (3 - r)[::-1]
        reads.append(Read(f"f{i}", r.astype(np.uint8)))
        expect.append(brute_best(codes, r, 2))
    from genome_weaver_align.ops.dp import edit_distance_semiglobal_host

    hits = al.align_batch(reads)
    for r, h, e in zip(reads, hits, expect):
        if h is None:
            # completeness: no hit allowed only if no <=k Hamming match exists
            assert e is None, r.name
            continue
        # soundness: the reported alignment must really have that edit
        # distance at that locus/strand
        codes_r = r.codes.astype(np.int64)
        if h.strand:
            codes_r = (3 - codes_r)[::-1]
        lo = max(0, h.pos - 2)
        win = codes[lo : h.pos + L + 2].astype(np.int64)
        assert edit_distance_semiglobal_host(codes_r, win) <= h.dist, r.name
        # dominance: edit distance <= best Hamming distance (pipeline may
        # legitimately beat the substitution-only oracle via an indel)
        if e is not None and not h.overflow:
            assert h.dist <= e[0], r.name
            if h.dist == e[0]:
                assert (h.pos, h.strand) <= (e[1], e[2]) or h.dist < e[0], r.name
