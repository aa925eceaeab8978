"""Vectorised SAM emission (utils.sam.lines_from_arrays) vs the per-read
object path: byte-identical for every read the object path can express
(VERDICT r3 missing-#6 — the array emitter is the production streaming
path, so its bytes must be pinned to the object path's)."""

import numpy as np

from genome_weaver_align.index.files import Genome, build_genome_index
from genome_weaver_align.models.pipeline import (
    SuffixFilterAligner,
    hits_from_arrays,
)
from genome_weaver_align.utils import simulate
from genome_weaver_align.utils.fasta import Read


def _setup(k=2, n_reads=64, L=80, with_indels=False, seed=7):
    rng = np.random.default_rng(seed)
    gi = build_genome_index(
        Genome.from_contigs(
            [
                Contig_g("gA", rng.integers(0, 4, size=24000, dtype=np.uint8)),
                Contig_g("gB", rng.integers(0, 4, size=16000, dtype=np.uint8)),
            ]
        ),
        sample_rate=16,
    )
    al = SuffixFilterAligner(gi, k=k)
    rarr, _, _, _ = simulate.simulate_reads_array(
        gi.genome.codes, n_reads - 2, L, seed=seed + 1, max_subs=min(2, k),
        indel_frac=0.2 if with_indels else 0.0,
    )
    # edge cases: an N-containing read and an unmappable read
    nr = rarr[0].copy()
    nr[5:8] = 4
    junk = rng.integers(0, 4, size=L, dtype=rarr.dtype)
    rarr = np.concatenate([rarr, nr[None], junk[None]], axis=0)
    lengths = np.full(n_reads, L, dtype=np.int32)
    return al, rarr, lengths


def Contig_g(name, codes):
    from genome_weaver_align.utils.fasta import Contig

    return Contig(name, codes)


def _object_lines(al, names, rarr, lengths, quals):
    reads = [
        Read(
            names[i],
            rarr[i, : lengths[i]].astype(np.uint8),
            None if quals is None else quals[i, : lengths[i]],
        )
        for i in range(len(names))
    ]
    ah = al.align_arrays_finish(al.align_arrays_submit(rarr.astype(np.int8), lengths))
    recs = al.to_sam(reads, hits_from_arrays(ah))
    return [r.line() for r in recs], ah


def _compare(al, rarr, lengths, quals=None):
    names = [f"r{i}" for i in range(rarr.shape[0])]
    obj_lines, ah = _object_lines(al, names, rarr, lengths, quals)
    arr_lines = al.to_sam_lines(names, rarr, lengths, ah, quals=quals)
    assert len(obj_lines) == len(arr_lines)
    for i, (o, a) in enumerate(zip(obj_lines, arr_lines)):
        unmapped_ovf = (not ah.mapped[i]) and bool(ah.overflow[i])
        if unmapped_ovf:
            # the array path is strictly more informative here: the object
            # path loses the overflow flag for unmapped reads (None hit)
            assert a == o + "\tXO:i:1" or a == o, (i, o, a)
        else:
            assert o == a, f"row {i}:\n  obj {o}\n  arr {a}"
    return ah


def test_lines_match_subs_only():
    al, rarr, lengths = _setup(k=2)
    ah = _compare(al, rarr, lengths)
    assert ah.mapped.sum() >= rarr.shape[0] - 2


def test_lines_match_with_indel_cigars():
    al, rarr, lengths = _setup(k=4, with_indels=True, seed=17)
    ah = _compare(al, rarr, lengths)
    assert ah.cigars, "expected at least one indel CIGAR in this cohort"
    assert ah.aux, "expected scored aux entries for the slow path"


def test_lines_match_with_quals_and_unscored():
    al, rarr, lengths = _setup(k=2, seed=23)
    al.scored = False
    rng = np.random.default_rng(0)
    quals = rng.integers(2, 40, size=rarr.shape).astype(np.int32)
    _compare(al, rarr, lengths, quals=quals)


def test_lines_ragged_lengths():
    al, rarr, lengths = _setup(k=2, seed=31)
    lengths = lengths.copy()
    lengths[::3] = 60  # ragged cohort: general (non-fused) path + seq slicing
    rarr = rarr.copy()
    for i in range(0, rarr.shape[0], 3):
        rarr[i, 60:] = 0
    _compare(al, rarr, lengths)
