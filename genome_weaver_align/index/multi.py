"""Multi-part index for genomes beyond the int32 device-index limit
(SURVEY.md §7 hard parts; whole-human-genome = ~3.1 Gbp > 2^31 codes is fine
host-side but device tables index with int32).

The genome's contigs are greedily packed into parts of <= ``part_limit``
bases; each part gets its own FM index (its own BWT coordinate space).  An
alignment run searches every part and merges per-read bests with the same
deterministic (dist, global_pos, strand) order — so a multi-part run is
bit-identical to a hypothetical single-index run.  Parts also give the
natural unit for placing sub-indexes on different hosts (config 5): each
host owns a subset of parts, merges ride cross-host all-gathers
(``parallel.multihost.gather_to_host``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.fasta import Contig
from ..utils.larray import PART_LIMIT as PART_LIMIT_DEFAULT
from ..utils.larray import check_device_indexable
from .build import FMIndexData, build_fm_index
from .files import Genome, GenomeIndex


@dataclass
class IndexPart:
    gi: GenomeIndex
    global_offset: int  # position of this part's base 0 in the whole genome
    contig_range: tuple[int, int]  # [first, last) contig index in the whole


@dataclass
class MultiIndex:
    names: list[str]  # all contig names, global order
    lengths: list[int]
    parts: list[IndexPart]

    @property
    def n_total(self) -> int:
        return sum(self.lengths)

    def coord(self, global_pos: int) -> tuple[str, int]:
        off = 0
        for name, ln in zip(self.names, self.lengths):
            if global_pos < off + ln:
                return name, global_pos - off
            off += ln
        raise ValueError(global_pos)


def build_multi_index(
    contigs: list[Contig],
    part_limit: int = PART_LIMIT_DEFAULT,
    sample_rate: int = 8,
    build_rev: bool = False,
) -> MultiIndex:
    names = [c.name for c in contigs]
    lengths = [int(c.codes.size) for c in contigs]
    parts: list[MultiIndex] = []
    out_parts = []
    i = 0
    global_off = 0
    while i < len(contigs):
        j = i
        total = 0
        while j < len(contigs) and total + contigs[j].codes.size <= part_limit:
            total += contigs[j].codes.size
            j += 1
        if j == i:
            raise ValueError(
                f"contig {names[i]} exceeds part_limit {part_limit}; split it"
            )
        genome = Genome.from_contigs(contigs[i:j])
        # device tables index with int32: a part (plus its $ sentinel row)
        # must stay device-indexable whatever part_limit the caller chose
        check_device_indexable(genome.codes.size + 1, "index part")
        fwd = build_fm_index(genome.codes, sample_rate=sample_rate)
        rev = (
            build_fm_index(genome.codes[::-1].copy(), sample_rate=sample_rate)
            if build_rev
            else None
        )
        out_parts.append(
            IndexPart(GenomeIndex(genome, fwd, rev), global_off, (i, j))
        )
        global_off += total
        i = j
    return MultiIndex(names, lengths, out_parts)


class MultiIndexAligner:
    """Runs the flagship aligner over every part; merges deterministically."""

    def __init__(self, mi: MultiIndex, k: int = 2, **aligner_kwargs):
        from ..models.pipeline import SuffixFilterAligner

        self.mi = mi
        self.k = k
        self.aligners = [
            SuffixFilterAligner(p.gi, k=k, **aligner_kwargs) for p in mi.parts
        ]

    def align_batch(self, reads):
        per_part = [al.align_batch(reads) for al in self.aligners]
        merged = []
        for ri in range(len(reads)):
            best = None
            for part, hits in zip(self.mi.parts, per_part):
                h = hits[ri]
                if h is None:
                    continue
                key = (h.dist, part.global_offset + h.pos, h.strand)
                if best is None or key < best[0]:
                    import dataclasses as _dc

                    gh = _dc.replace(h, pos=part.global_offset + h.pos)
                    best = (key, gh)
            merged.append(best[1] if best else None)
        return merged

    def to_sam(self, reads, hits):
        from ..utils import sam as sam_mod
        from ..utils.fasta import Read

        recs = []
        for r, h in zip(reads, hits):
            if h is None:
                recs.append(sam_mod.unmapped(r.name, r.codes, r.qual))
                continue
            name, local = self.mi.coord(h.pos)
            recs.append(
                sam_mod.mapped(
                    r.name,
                    r.codes,
                    name,
                    int(local),
                    h.strand,
                    h.cigar,
                    edit_distance=h.dist,
                    mapq=37 if h.n_good == 1 else 3,
                    qual=r.qual,
                )
            )
        return recs

    def sam_header(self) -> str:
        from ..utils import sam as sam_mod

        return sam_mod.header(self.mi.names, self.mi.lengths)
