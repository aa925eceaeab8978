"""Streaming multi-part index IO (index/multipart_io.py) at toy scale.

The production operating point is the >=1 Gbp bench (`bench.py --only gbp`
against scripts/build_gbp_index.py output); this pins the SEMANTICS on a
2-part toy genome: save/load round-trip, part-at-a-time streaming, and the
deterministic cross-part improve-merge being bit-identical to aligning
against a single whole-genome index.
"""

import json

import numpy as np
import pytest

from genome_weaver_align.index import seedtable
from genome_weaver_align.index.build import build_fm_index
from genome_weaver_align.index.files import Genome, GenomeIndex
from genome_weaver_align.index import multipart_io as mp
from genome_weaver_align.models.pipeline import SuffixFilterAligner

J = 6
L, K = 40, 2


def _build_parts(tmp_path, rng, n_per_part=6000, n_parts=2):
    parts_codes = []
    offsets = [0]
    for p in range(n_parts):
        codes = rng.integers(0, 4, size=n_per_part, dtype=np.uint8)
        # plant shared repeat units across parts so cross-part ties exercise
        # the deterministic (dist, global_pos, strand) merge order
        unit = rng.integers(0, 4, size=60, dtype=np.uint8)
        for s in rng.integers(0, n_per_part - 60, size=6):
            codes[s : s + 60] = unit
        parts_codes.append(codes)
        offsets.append(offsets[-1] + n_per_part)

    part_dir = tmp_path / "parts"
    for p, codes in enumerate(parts_codes):
        fm = build_fm_index(codes, sample_rate=8)
        so, sp = seedtable.build_seed_table(codes, J)
        mp.save_part(
            part_dir, p, fm, so, sp, J,
            mp.PartMeta(
                names=[f"c{p}"], lengths=[codes.size], global_offset=offsets[p]
            ),
        )
    (part_dir / "parts.json").write_text(
        json.dumps(
            dict(
                n_parts=n_parts,
                names=[f"c{p}" for p in range(n_parts)],
                lengths=[n_per_part] * n_parts,
                part_offsets=offsets[:-1],
            )
        )
    )
    return part_dir, parts_codes, offsets


def _write_rev(part_dir, p, codes):
    """What scripts/build_gbp_rev.py writes, at toy scale."""
    rev = build_fm_index(codes[::-1].copy(), sample_rate=8)
    marks = rev.ssa_marks.get(np.arange(rev.n + 1))
    np.savez(
        part_dir / f"part{p}_rev.npz",
        n=rev.n, primary=rev.primary, counts=rev.counts, C=rev.C,
        bwt_words=rev.bwt_words, occ_cp_i32=rev.occ_cp.astype(np.int32),
        sample_rate=rev.sample_rate, mark_bits=np.packbits(marks),
        ssa_values_i32=rev.ssa_values.astype(np.int32),
        text_words=rev.text_words,
    )


def test_staircase_rescue_maps_flooded_reads(tmp_path):
    """A read inside a high-copy repeat family floods every seed bucket, so
    the streaming pass truncates past its own locus (unmapped); the deferred
    staircase rescue (per-part reverse indexes present) must map it exactly.
    """
    rng = np.random.default_rng(3)
    n_per_part = 6000
    part0 = rng.integers(0, 4, size=n_per_part, dtype=np.uint8)
    # part 1: 50 copies of a 60bp unit, each with 4 private mutations ->
    # copies differ by ~8 bases (>k within any 40bp window), buckets ~50 wide
    unit = rng.integers(0, 4, size=60, dtype=np.uint8)
    copies = []
    for _ in range(50):
        c = unit.copy()
        at = rng.choice(60, size=4, replace=False)
        c[at] = (c[at] + rng.integers(1, 4, size=4)) % 4
        copies.append(c)
    part1 = np.concatenate(
        [rng.integers(0, 4, size=1500, dtype=np.uint8)]
        + copies
        + [rng.integers(0, 4, size=n_per_part - 1500 - 50 * 60, dtype=np.uint8)]
    )
    parts_codes = [part0, part1]
    offsets = [0, n_per_part, 2 * n_per_part]

    part_dir = tmp_path / "parts"
    for p, codes in enumerate(parts_codes):
        fm = build_fm_index(codes, sample_rate=8)
        so, sp = seedtable.build_seed_table(codes, J)
        mp.save_part(
            part_dir, p, fm, so, sp, J,
            mp.PartMeta(names=[f"c{p}"], lengths=[codes.size], global_offset=offsets[p]),
        )
        _write_rev(part_dir, p, codes)
    (part_dir / "parts.json").write_text(
        json.dumps(dict(n_parts=2, names=["c0", "c1"],
                        lengths=[n_per_part] * 2, part_offsets=offsets[:-1]))
    )
    mi = mp.load_multi_index(part_dir)

    B = 32
    Lr = 40
    # reads from inside repeat copies (one planted sub each) + normal reads
    n_rep, n_norm = 8, 24
    rep_start = 1500 + 60 * np.arange(4, 4 + n_rep) + 10  # inside copies 4..11
    reads = np.zeros((B, Lr), dtype=np.int8)
    true_g = np.zeros(B, dtype=np.int64)
    for t in range(n_rep):
        s = int(rep_start[t])
        row = part1[s : s + Lr].copy()
        row[7] = (row[7] + 1) % 4
        reads[t] = row
        true_g[t] = offsets[1] + s
    whole = np.concatenate(parts_codes)
    for t in range(n_rep, B):
        s = int(rng.integers(0, n_per_part - Lr))  # part 0, repeat-free
        reads[t] = part0[s : s + Lr]
        true_g[t] = s
    lengths_row = np.full(B, Lr, np.int32)

    dist, gpos, strand, mapped, align_s, load_s = mp.align_stream_multipart(
        mi, reads, lengths_row, B, k=K
    )
    assert mapped.all(), np.nonzero(~mapped)[0]
    # repeat reads must land on their OWN copy (other copies are > k away)
    assert np.array_equal(gpos[:n_rep], true_g[:n_rep])
    assert (dist[:n_rep] == 1).all()
    assert (strand == 0).all()

    # flat layout: same stream + rescue (last part resident, earlier parts
    # FM-only reload) must be bit-identical to the npz path
    for p in range(2):
        mp.convert_part_to_flat(part_dir, p)
    stats = {}
    d2, g2, s2, m2, _, _ = mp.align_stream_multipart(
        mi, reads, lengths_row, B, k=K, stats=stats
    )
    assert stats["format"] == "flat"
    assert np.array_equal(d2, dist) and np.array_equal(g2, gpos)
    assert np.array_equal(s2, strand) and np.array_equal(m2, mapped)


def test_flat_matches_from_host(tmp_path):
    """The flat layout's device arrays must be byte-identical to what
    rank.from_host uploads from the npz load path (blocks fusing, LSB-first
    mark words, checkpoint cumsum) — for the forward AND reverse tables."""
    from genome_weaver_align.ops import rank

    rng = np.random.default_rng(7)
    part_dir, parts_codes, _ = _build_parts(tmp_path, rng, n_per_part=3000)
    _write_rev(part_dir, 0, parts_codes[0])
    mp.convert_part_to_flat(part_dir, 0)

    gi, (so, sp), j, goff = mp.load_part(part_dir, 0)
    ref = rank.from_host(gi.fwd)
    fp = mp.load_part_flat(part_dir, 0)
    assert fp.n == gi.fwd.n and fp.seed_j == j and fp.global_offset == goff
    assert np.array_equal(np.asarray(fp.fm.blocks), np.asarray(ref.blocks))
    assert np.array_equal(
        np.asarray(fp.fm.mark_blocks), np.asarray(ref.mark_blocks)
    )
    assert np.array_equal(np.asarray(fp.fm.mark_cp), np.asarray(ref.mark_cp))
    assert np.array_equal(
        np.asarray(fp.fm.ssa_values), np.asarray(ref.ssa_values)
    )
    assert np.array_equal(np.asarray(fp.fm.C), np.asarray(ref.C))
    assert int(fp.fm.primary) == int(ref.primary)
    assert fp.fm.sample_rate == ref.sample_rate
    assert np.array_equal(
        np.asarray(fp.text_words), gi.fwd.text_words
    )
    assert np.array_equal(np.asarray(fp.seed_tab[0]), so)
    assert np.array_equal(np.asarray(fp.seed_tab[1]), sp)

    rev_host = mp.load_rev(part_dir, 0)
    ref_rev = rank.from_host(rev_host)
    dev_rev = mp.load_rev_flat(part_dir, 0)
    assert np.array_equal(np.asarray(dev_rev.blocks), np.asarray(ref_rev.blocks))
    assert np.array_equal(
        np.asarray(dev_rev.mark_blocks), np.asarray(ref_rev.mark_blocks)
    )
    assert np.array_equal(
        np.asarray(dev_rev.mark_cp), np.asarray(ref_rev.mark_cp)
    )
    assert np.array_equal(
        np.asarray(dev_rev.ssa_values), np.asarray(ref_rev.ssa_values)
    )

    # want_fm=False: dummy FM tables but real metadata (seed streaming path)
    fp2 = mp.load_part_flat(part_dir, 0, want_fm=False, want_seed=False)
    assert fp2.fm.n == gi.fwd.n and fp2.seed_tab is None
    assert np.asarray(fp2.fm.blocks).shape == (1, 12)


def test_save_load_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    part_dir, parts_codes, _ = _build_parts(tmp_path, rng)
    gi, (so, sp), j, goff = mp.load_part(part_dir, 1)
    assert j == J and goff == parts_codes[0].size
    fm2 = build_fm_index(parts_codes[1], sample_rate=8)
    assert gi.fwd.n == fm2.n and gi.fwd.primary == fm2.primary
    assert np.array_equal(gi.fwd.bwt_words, fm2.bwt_words)
    assert np.array_equal(gi.fwd.ssa_values, fm2.ssa_values)
    so2, sp2 = seedtable.build_seed_table(parts_codes[1], J)
    assert np.array_equal(so, so2) and np.array_equal(sp, sp2)
    # extract goes through packed text_words (codes intentionally empty)
    assert np.array_equal(
        gi.fwd.extract(100, 60), parts_codes[1][100:160].astype(np.int64)
    )


def test_stream_merge_matches_single_index(tmp_path):
    rng = np.random.default_rng(1)
    part_dir, parts_codes, offsets = _build_parts(tmp_path, rng)
    mi = mp.load_multi_index(part_dir)
    whole = np.concatenate(parts_codes)

    B = 32
    n_reads = 64
    starts = rng.integers(0, whole.size - L, size=n_reads)
    # keep reads inside one part (a part boundary is a real contig boundary)
    starts = np.where(
        (starts % parts_codes[0].size) > parts_codes[0].size - L,
        starts - L,
        starts,
    )
    reads = whole[starts[:, None] + np.arange(L)[None, :]].astype(np.int8)
    subs_at = rng.integers(0, L, size=n_reads)
    reads[np.arange(n_reads), subs_at] = (
        reads[np.arange(n_reads), subs_at] + 1
    ) % 4
    lengths_row = np.full(B, L, np.int32)

    dist, gpos, strand, mapped, align_s, load_s = mp.align_stream_multipart(
        mi, reads, lengths_row, B, k=K
    )
    assert mapped.all()
    assert align_s > 0 and load_s > 0

    # flat path (no rev -> no rescue) must reproduce the npz stream exactly
    for p in range(2):
        mp.convert_part_to_flat(part_dir, p)
    stats = {}
    d2, g2, s2, m2, _, _ = mp.align_stream_multipart(
        mi, reads, lengths_row, B, k=K, stats=stats
    )
    assert stats["format"] == "flat"
    assert np.array_equal(d2, dist) and np.array_equal(g2, gpos)
    assert np.array_equal(s2, strand)

    # oracle: one aligner over the concatenated genome, same seed_j budgets
    genome = Genome(
        names=["c0", "c1"],
        offsets=np.array([0, offsets[1], offsets[2]], dtype=np.int64),
        codes=whole,
        n_mask_spans=np.zeros((0, 2), np.int64),
    )
    fmw = build_fm_index(whole, sample_rate=8)
    sow, spw = seedtable.build_seed_table(whole, J)
    alw = SuffixFilterAligner(
        GenomeIndex(genome, fmw, None), k=K, max_hits_per_piece=16,
        seed_table=(sow, spw), seed_j=J, max_cands=32, verify_slack=4,
    )
    for b in range(n_reads // B):
        sl = slice(b * B, (b + 1) * B)
        ah = alw.align_arrays_finish(
            alw.align_arrays_submit(reads[sl], lengths_row)
        )
        assert np.array_equal(ah.mapped, mapped[sl])
        assert np.array_equal(ah.dist, dist[sl])
        # merge order (dist, global_pos, strand) == the single-index
        # deterministic best: positions agree even inside repeat families
        assert np.array_equal(np.asarray(ah.pos), gpos[sl]), b
        assert np.array_equal(np.asarray(ah.strand), strand[sl])
