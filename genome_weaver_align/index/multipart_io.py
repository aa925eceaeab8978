"""Disk layout + streaming alignment for multi-part indexes beyond 2^31
(SURVEY.md §7 hard parts; BASELINE.json config 5 at real scale).

``index.multi`` proves the merge semantics at toy scale but keeps every
part's tables in RAM and on-device at once — impossible for a ~3 Gbp
genome whose parts each carry multi-GB seed tables.  This module is the
production-scale counterpart:

- each part is serialized standalone (FM arrays + CSR seed table + its
  slice of the contig table), so a build can stream parts through RAM;
- alignment iterates PARTS in the outer loop and read batches in the
  inner loop: one part's tables are HBM-resident at a time, every batch
  is scanned against it, per-read bests improve-merge across parts with
  the same deterministic (dist, global_pos, strand) order as
  ``index.multi.MultiIndexAligner`` — so the result is bit-identical to
  a hypothetical single-index run, while peak device memory stays one
  part's footprint.

Two on-disk formats:

- **npz** (``save_part``/``load_part``): the original layout; kept as the
  build-time output and the fallback loader.  Loading pays npz copy +
  ``unpackbits`` + BitVector reconstruction + ``from_host`` fusing —
  minutes per 1.6 Gbp part.
- **flat** (``part{i}.flat/`` + manifest): DEVICE-READY raw arrays —
  exactly what ``ops.rank.DeviceFMIndex`` holds — written once by
  ``convert_part_to_flat`` (or a fresh build).  Loading is np.memmap +
  jnp.asarray page-in/upload with ZERO host transformation, so a part
  costs disk and host-to-device bandwidth only, and a rescue pass
  can load the FM tables WITHOUT the multi-GB seed table.

Build entry point: ``scripts/build_gbp_index.py`` (offline, native SA-IS
per part; records build times into ``gbp_meta.json`` for the bench);
``scripts/convert_gbp_flat.py`` converts an existing npz part dir.
"""

from __future__ import annotations

import gc
import json
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..utils.bitvector import BitVector
from .build import FMIndexData


@dataclass
class PartMeta:
    names: list[str]  # contig names in this part
    lengths: list[int]
    global_offset: int  # genome-global position of this part's base 0


def save_part(
    part_dir: Path,
    i: int,
    fm: FMIndexData,
    seed_offsets: np.ndarray,
    seed_positions: np.ndarray,
    seed_j: int,
    meta: PartMeta,
) -> int:
    """Serialize one part; returns the device-upload byte total (the HBM
    footprint this part costs while active)."""
    part_dir.mkdir(parents=True, exist_ok=True)
    marks = fm.ssa_marks.get(np.arange(fm.n + 1))
    np.savez(
        part_dir / f"part{i}.npz",
        n=fm.n,
        primary=fm.primary,
        counts=fm.counts,
        C=fm.C,
        bwt_words=fm.bwt_words,
        occ_cp_i32=fm.occ_cp.astype(np.int32),
        sample_rate=fm.sample_rate,
        mark_bits=np.packbits(marks),
        ssa_values_i32=fm.ssa_values.astype(np.int32),
        text_words=fm.text_words,
        seed_offsets=seed_offsets,
        seed_positions=seed_positions,
        seed_j=seed_j,
        names=np.array(meta.names),
        lengths=np.array(meta.lengths, dtype=np.int64),
        global_offset=np.int64(meta.global_offset),
    )
    hbm = (
        fm.bwt_words.nbytes
        + fm.occ_cp.size * 4  # int32 on device
        + marks.size // 8
        + fm.ssa_values.size * 4
        + fm.text_words.nbytes
        + seed_offsets.nbytes
        + seed_positions.nbytes
    )
    return int(hbm)


def load_part(part_dir: Path, i: int):
    """-> (GenomeIndex, (seed_offsets, seed_positions), seed_j, global_offset).

    The Genome carries an EMPTY codes array: the aligner's window/traceback
    reads go through the packed ``text_words`` (fm.extract), and SAM
    emission only needs names/offsets — holding 1.6 GB of raw codes per
    part in host RAM would defeat the streaming layout."""
    from .files import Genome, GenomeIndex

    z = np.load(part_dir / f"part{i}.npz")
    n = int(z["n"])
    bits = np.unpackbits(z["mark_bits"])[: n + 1].astype(bool)
    fm = FMIndexData(
        n=n,
        primary=int(z["primary"]),
        counts=z["counts"],
        C=z["C"],
        bwt_words=z["bwt_words"],
        occ_cp=z["occ_cp_i32"].astype(np.int64),
        sample_rate=int(z["sample_rate"]),
        ssa_marks=BitVector(bits),
        ssa_values=z["ssa_values_i32"].astype(np.int64),
        text_words=z["text_words"],
    )
    lengths = z["lengths"]
    offsets = np.zeros(lengths.size + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    genome = Genome(
        names=[str(s) for s in z["names"]],
        offsets=offsets,
        codes=np.zeros(0, dtype=np.uint8),
        n_mask_spans=np.zeros((0, 2), np.int64),
    )
    gi = GenomeIndex(genome, fm, None)
    return (
        gi,
        (z["seed_offsets"], z["seed_positions"]),
        int(z["seed_j"]),
        int(z["global_offset"]),
    )


def load_rev(part_dir: Path, i: int) -> FMIndexData | None:
    """Reverse-text FM of part i (scripts/build_gbp_rev.py), or None.

    Only needed by the staircase rescue pass; streaming alignment proper
    never touches it."""
    p = Path(part_dir) / f"part{i}_rev.npz"
    if not p.exists():
        return None
    z = np.load(p)
    n = int(z["n"])
    bits = np.unpackbits(z["mark_bits"])[: n + 1].astype(bool)
    return FMIndexData(
        n=n,
        primary=int(z["primary"]),
        counts=z["counts"],
        C=z["C"],
        bwt_words=z["bwt_words"],
        occ_cp=z["occ_cp_i32"].astype(np.int64),
        sample_rate=int(z["sample_rate"]),
        ssa_marks=BitVector(bits),
        ssa_values=z["ssa_values_i32"].astype(np.int64),
        text_words=z["text_words"],
    )


# ------------------------------------------------------------------ flat


def _marks_to_device(mark_bits: np.ndarray, n_rows: int):
    """np.packbits(bool marks) -> (mark_blocks (mb,4) u32, mark_cp (mb+1,) i32).

    Vectorised twin of ``BitVector.__init__`` + the ``from_host`` reshape:
    unpack big-endian bytes, repack LSB-first (little bitorder bytes -> LE
    uint32 view IS the LSB-first-within-word layout the device kernels
    read), then per-128-bit-block popcount checkpoints."""
    bits = np.unpackbits(mark_bits)[:n_rows]
    by = np.packbits(bits, bitorder="little")
    pad = (-by.size) % 16  # 128-bit blocks
    if pad or by.size == 0:
        by = np.concatenate([by, np.zeros(max(pad, 16 - by.size), np.uint8)])
    words = by.view("<u4")
    mb = words.size // 4
    pc = np.bitwise_count(words).astype(np.int64) if hasattr(np, "bitwise_count") else None
    if pc is None:  # numpy < 2.0 fallback
        from ..utils.packing import popcount32

        pc = popcount32(words).astype(np.int64)
    per_block = pc.reshape(mb, 4).sum(axis=1)
    mark_cp = np.zeros(mb + 1, dtype=np.int32)
    mark_cp[1:] = np.cumsum(per_block)
    return words.reshape(mb, 4).copy(), mark_cp


_FLAT_FILES = {
    # name -> (filename, dtype); shapes recorded in the manifest
    "blocks": ("fwd.blocks.bin", "uint32"),
    "mark_blocks": ("fwd.mark_blocks.bin", "uint32"),
    "mark_cp": ("fwd.mark_cp.bin", "int32"),
    "ssa_values": ("fwd.ssa.bin", "int32"),
    "text_words": ("text.bin", "uint32"),
    "seed_offsets": ("seed_offsets.bin", "int32"),
    "seed_positions": ("seed_positions.bin", "int32"),
    "rev.blocks": ("rev.blocks.bin", "uint32"),
    "rev.mark_blocks": ("rev.mark_blocks.bin", "uint32"),
    "rev.mark_cp": ("rev.mark_cp.bin", "int32"),
    "rev.ssa_values": ("rev.ssa.bin", "int32"),
}


def flat_dir(part_dir: Path, i: int) -> Path:
    return Path(part_dir) / f"part{i}.flat"


def _flat_write(d: Path, manifest: dict, name: str, arr: np.ndarray):
    fname, dtype = _FLAT_FILES[name]
    arr = np.ascontiguousarray(arr, dtype=np.dtype(dtype))
    arr.tofile(d / fname)
    manifest["arrays"][name] = {"dtype": dtype, "shape": list(arr.shape)}


def convert_part_to_flat(part_dir: Path, i: int, log=lambda m: None) -> Path:
    """One-time npz -> flat conversion of part i (+ its rev, if present).

    Writes ``part{i}.flat/`` next to the npz; idempotent (skips if the
    manifest already exists).  The flat arrays are byte-identical to what
    ``rank.from_host(load_part(...).fwd)`` would upload — pinned by
    tests/test_multipart_io.py::test_flat_matches_from_host."""
    from ..ops.rank import fuse_blocks

    part_dir = Path(part_dir)
    d = flat_dir(part_dir, i)
    if (d / "manifest.json").exists():
        return d
    d.mkdir(parents=True, exist_ok=True)
    z = np.load(part_dir / f"part{i}.npz")
    n = int(z["n"])
    manifest = {
        "version": 1,
        "n": n,
        "primary": int(z["primary"]),
        "sample_rate": int(z["sample_rate"]),
        "C": [int(x) for x in z["C"]],
        "counts": [int(x) for x in z["counts"]],
        "seed_j": int(z["seed_j"]),
        "global_offset": int(z["global_offset"]),
        "names": [str(s) for s in z["names"]],
        "lengths": [int(x) for x in z["lengths"]],
        "arrays": {},
    }
    t0 = time.time()
    _flat_write(d, manifest, "blocks", fuse_blocks(z["bwt_words"], z["occ_cp_i32"]))
    mb_arr, mcp = _marks_to_device(z["mark_bits"], n + 1)
    _flat_write(d, manifest, "mark_blocks", mb_arr)
    _flat_write(d, manifest, "mark_cp", mcp)
    _flat_write(d, manifest, "ssa_values", z["ssa_values_i32"])
    _flat_write(d, manifest, "text_words", z["text_words"])
    _flat_write(d, manifest, "seed_offsets", z["seed_offsets"])
    _flat_write(d, manifest, "seed_positions", z["seed_positions"])
    del z
    gc.collect()

    rp = part_dir / f"part{i}_rev.npz"
    if rp.exists():
        zr = np.load(rp)
        rn = int(zr["n"])
        manifest["rev"] = {
            "n": rn,
            "primary": int(zr["primary"]),
            "sample_rate": int(zr["sample_rate"]),
            "C": [int(x) for x in zr["C"]],
        }
        _flat_write(d, manifest, "rev.blocks", fuse_blocks(zr["bwt_words"], zr["occ_cp_i32"]))
        mb_arr, mcp = _marks_to_device(zr["mark_bits"], rn + 1)
        _flat_write(d, manifest, "rev.mark_blocks", mb_arr)
        _flat_write(d, manifest, "rev.mark_cp", mcp)
        _flat_write(d, manifest, "rev.ssa_values", zr["ssa_values_i32"])
        del zr
        gc.collect()
    (d / "manifest.json").write_text(json.dumps(manifest))
    log(f"part {i}: flat conversion in {time.time()-t0:.1f}s -> {d}")
    return d


def _flat_mmap(d: Path, manifest: dict, name: str) -> np.ndarray:
    fname, _ = _FLAT_FILES[name]
    spec = manifest["arrays"][name]
    return np.memmap(
        d / fname, dtype=np.dtype(spec["dtype"]), mode="r",
        shape=tuple(spec["shape"]),
    )


def _flat_read(d: Path, manifest: dict, name: str) -> np.ndarray:
    """Sequential read into process RAM (np.fromfile).  Uploading straight
    from a cold memmap page-faults 4 KB at a time; fromfile reads at disk
    speed and the upload then runs from host-resident memory.  This is also what the
    background prefetch thread calls, so the next part's arrays are
    already host-resident when its turn comes."""
    fname, _ = _FLAT_FILES[name]
    spec = manifest["arrays"][name]
    return np.fromfile(d / fname, dtype=np.dtype(spec["dtype"])).reshape(
        tuple(spec["shape"])
    )


_STREAM_ARRAYS = ("text_words", "seed_offsets", "seed_positions")
_FM_ARRAYS = ("blocks", "mark_blocks", "mark_cp", "ssa_values")
_REV_ARRAYS = ("rev.blocks", "rev.mark_blocks", "rev.mark_cp", "rev.ssa_values")


def _read_part_arrays(part_dir: Path, i: int, names) -> dict:
    d = flat_dir(part_dir, i)
    manifest = json.loads((d / "manifest.json").read_text())
    return {n: _flat_read(d, manifest, n) for n in names if n in manifest["arrays"]}


@dataclass
class FlatPart:
    """One flat part's device-resident tables + host metadata."""

    fm: object  # DeviceFMIndex (real, or dummy tables when want_fm=False —
    # the seed streaming path reads only fm.n / fm.C, never the FM arrays)
    text_words: object  # device (nw,) uint32
    text_host: object  # host (nw,) uint32 (slow-path window decode)
    seed_tab: tuple | None  # (offsets, positions) on device
    genome: object  # index.files.Genome (names/offsets, empty codes)
    n: int
    seed_j: int
    global_offset: int
    has_rev: bool


def load_part_flat(
    part_dir: Path,
    i: int,
    *,
    want_seed: bool = True,
    want_fm: bool = True,
    arrays: dict | None = None,
) -> FlatPart:
    """Read + upload one flat part.  ``want_fm=False`` uploads 1-row dummy
    FM tables (the seed-path streaming step never gathers from them) —
    saves ~2 GB of upload per part AND keeps ONE streaming executable
    across parts; ``want_seed=False`` skips the multi-GB seed table
    (rescue passes need FM + text only).  ``arrays`` supplies host arrays
    already read by a background prefetch thread (``_read_part_arrays``)."""
    import jax.numpy as jnp

    from ..ops import rank
    from .files import Genome, GenomeIndex  # noqa: F401 (Genome used below)

    d = flat_dir(part_dir, i)
    manifest = json.loads((d / "manifest.json").read_text())
    n = manifest["n"]
    C = np.asarray(manifest["C"], np.int64)
    arrays = arrays or {}
    get = lambda name: (
        arrays[name] if name in arrays else _flat_read(d, manifest, name)
    )
    if want_fm:
        fm = rank.from_arrays(
            blocks=get("blocks"),
            C=C,
            primary=manifest["primary"],
            mark_blocks=get("mark_blocks"),
            mark_cp=get("mark_cp"),
            ssa_values=get("ssa_values"),
            n=n,
            sample_rate=manifest["sample_rate"],
        )
    else:
        fm = rank.from_arrays(
            blocks=np.zeros((1, 12), np.uint32),
            C=C,
            primary=manifest["primary"],
            mark_blocks=np.zeros((1, 4), np.uint32),
            mark_cp=np.zeros(2, np.int32),
            ssa_values=np.zeros(1, np.int32),
            n=n,
            sample_rate=manifest["sample_rate"],
        )
    text_host = get("text_words")
    text = jnp.asarray(text_host)
    seed = None
    if want_seed:
        seed = (
            jnp.asarray(get("seed_offsets")),
            jnp.asarray(get("seed_positions")),
        )
    lengths = np.asarray(manifest["lengths"], np.int64)
    offsets = np.zeros(lengths.size + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    genome = Genome(
        names=list(manifest["names"]),
        offsets=offsets,
        codes=np.zeros(0, dtype=np.uint8),
        n_mask_spans=np.zeros((0, 2), np.int64),
    )
    return FlatPart(
        fm=fm,
        text_words=text,
        text_host=text_host,
        seed_tab=seed,
        genome=genome,
        n=n,
        seed_j=manifest["seed_j"],
        global_offset=manifest["global_offset"],
        has_rev="rev" in manifest,
    )


def load_rev_flat(part_dir: Path, i: int, arrays: dict | None = None):
    """DeviceFMIndex of part i's reverse text from the flat layout, or None."""
    from ..ops import rank

    d = flat_dir(part_dir, i)
    manifest = json.loads((d / "manifest.json").read_text())
    if "rev" not in manifest:
        return None
    r = manifest["rev"]
    arrays = arrays or {}
    get = lambda name: (
        arrays[name] if name in arrays else _flat_read(d, manifest, name)
    )
    return rank.from_arrays(
        blocks=get("rev.blocks"),
        C=np.asarray(r["C"], np.int64),
        primary=r["primary"],
        mark_blocks=get("rev.mark_blocks"),
        mark_cp=get("rev.mark_cp"),
        ssa_values=get("rev.ssa_values"),
        n=r["n"],
        sample_rate=r["sample_rate"],
    )


def has_flat(part_dir: Path, n_parts: int) -> bool:
    return all(
        (flat_dir(part_dir, p) / "manifest.json").exists() for p in range(n_parts)
    )


# ------------------------------------------------------------ streaming


@dataclass
class MultiPartIndex:
    part_dir: Path
    n_parts: int
    names: list[str]  # all contig names, global order
    lengths: list[int]
    part_offsets: list[int]


def load_multi_index(part_dir: Path) -> MultiPartIndex:
    meta = json.loads((Path(part_dir) / "parts.json").read_text())
    return MultiPartIndex(
        part_dir=Path(part_dir),
        n_parts=meta["n_parts"],
        names=meta["names"],
        lengths=meta["lengths"],
        part_offsets=meta["part_offsets"],
    )


def _part_budgets(n: int, seed_j: int) -> tuple[int, int, int]:
    """(max_hits, max_cands, verify_slack) scaled to part size.

    Budgets scale with part size: the mean j-mer bucket holds n/4^j
    positions (~24 at 1.6 Gbp, j=13), so the 230 Mbp defaults (8/12)
    would flood EVERY read into the 16x tier-1 rerun.  The verify cap
    stays tight because verify temps are O(B * max_cands * 16L) bytes
    next to 8.7 GB of tables (70 cands x 16k ran out of memory on the
    previous accelerator).

    max_cands and verify_slack must cover the PROPOSAL DISTRIBUTION, not
    just one bucket: measured on the 1.6 Gbp part (r5), the rarest-of-4
    probe averages ~0.73x the mean bucket, so a k=2 read proposes
    ~3 x 17.6 = 53 candidates (p90 59, p99 105) — the r4 max_cands=32
    truncated EVERY read (dedupe overflow 71-96% of each batch) and the
    chunked tier-1 rerun became the primary path, most of each batch,
    while true bucket-width overflow was only 127/4096 reads.  max_cands now covers
    the worst case (pieces x max_hits, capped 128); slack — the compact
    pool's AVERAGE lanes/read — covers the mean proposal count with ~20%
    margin.  Small parts keep the old 4/pieces*hits shapes."""
    P = 3  # k=2 pieces; budgets are computed for the flagship k
    mean_bucket = n / 4**seed_j
    max_hits = max(8, min(64, int(1.5 * mean_bucket)))
    max_cands = max(12, min(128, P * max_hits))
    slack = max(4, min(max_cands, int(0.9 * P * mean_bucket)))
    return max_hits, max_cands, slack


class _Best:
    """Per-read running best with the deterministic (dist, global_pos,
    strand) improve-merge order of ``index.multi.MultiIndexAligner``."""

    INF = 1 << 20

    def __init__(self, n: int):
        self.dist = np.full(n, self.INF, np.int64)
        self.gpos = np.full(n, np.int64(1) << 62, np.int64)
        self.strand = np.zeros(n, np.int64)
        self.n_good = np.zeros(n, np.int64)
        self.overflow = np.zeros(n, bool)

    def merge(self, rows, ah, goff, m=None):
        """Improve-merge batch results ``ah`` (ArrayHits) at ``rows``."""
        m = len(rows) if m is None else m
        d = np.where(ah.mapped[:m], ah.dist[:m], self.INF)
        g = np.where(ah.mapped[:m], ah.pos[:m] + goff, np.int64(1) << 62)
        st = ah.strand[:m]
        cur_d, cur_g, cur_s = self.dist[rows], self.gpos[rows], self.strand[rows]
        better = (d < cur_d) | (
            (d == cur_d) & ((g < cur_g) | ((g == cur_g) & (st < cur_s)))
        )
        self.dist[rows] = np.where(better, d, cur_d)
        self.gpos[rows] = np.where(better, g, cur_g)
        self.strand[rows] = np.where(better, st, cur_s)
        # n_good ACCUMULATES across parts: a read unique within its winning
        # part but with an equal-distance copy in another part is genuinely
        # ambiguous, and the winner's per-part count alone under-flags it
        # (measured r5: 1/131k position-wrong read "claimed unique" until
        # cross-part summing).  Per part the count already covers both
        # strands; rescue passes only touch reads whose streaming counts
        # were 0 (unmapped => no within-threshold candidate), so summing
        # never double-counts a part.
        self.n_good[rows] = self.n_good[rows] + np.asarray(
            ah.n_good[:m], np.int64
        )
        self.overflow[rows] |= np.asarray(ah.overflow[:m], bool)
        return better


def _rescue_with(al2, reads, un, best: "_Best", goff: int, L: int, chunk=1024):
    """Staircase-rescue the reads at indices ``un`` against one part,
    improve-merging into ``best``.  Chunks are pipelined (submit N+1
    before finishing N) so device work overlaps host merge.

    chunk=1024: the shape the rescue was proven at on the previous
    accelerator (a 2048-read narrow-left chunk crashed there); the staircase
    is depth-bound, so two 1024 chunks cost about the same as one 2048
    chunk.  To be re-derived on the GPU."""
    def submit(ch):
        P = chunk if un.size > chunk else max(
            128, 1 << (int(ch.size) - 1).bit_length()
        )
        sel = np.concatenate([ch, np.full(P - ch.size, ch[0], ch.dtype)])
        return al2.align_arrays_submit(reads[sel], np.full(P, L, np.int32))

    from ..models.pipeline import prefetch_result as _pf

    chunks = [un[o : o + chunk] for o in range(0, un.size, chunk)]
    n_rescued = 0
    pending = submit(chunks[0])
    _pf(pending)
    for ci, ch in enumerate(chunks):
        nxt = submit(chunks[ci + 1]) if ci + 1 < len(chunks) else None
        _pf(nxt)
        ah = al2.align_arrays_finish(pending)
        pending = nxt
        better = best.merge(ch, ah, goff, m=ch.size)
        n_rescued += int(better.sum())
    return n_rescued


def align_stream_multipart(
    mi: MultiPartIndex,
    reads: np.ndarray,  # (N, L) int8 forward verify codes
    lengths_row: np.ndarray,  # (B,) — uniform batch shape
    batch: int,
    k: int = 2,
    log=lambda m: None,
    stats: dict | None = None,
    debug_out: dict | None = None,
):
    """Align every read against every part, improve-merging per-read bests.

    Returns (best_dist, best_gpos, best_strand, mapped, align_s, load_s)
    with genome-GLOBAL positions.  Parts stream through HBM one at a time.

    ``align_s`` counts device+merge time only; ``load_s`` is the per-part
    disk-load + HBM upload total, reported separately because it is a
    once-per-part cost that amortizes over the WHOLE read stream (a
    production run streams millions of reads per part; a bench that folds
    one-time load into a short stream would measure the disk, not the
    aligner).  Pass ``stats`` (a dict) to receive per-phase attribution:
    batch times, tier-1/tier-2 ms, rescue split (VERDICT r4 ask #1).

    Streaming passes run seed+tier-1 only.  The staircase completeness
    backstop (tier-2) is DEFERRED to a final rescue pass over the reads
    still unmapped after the cross-part merge — during streaming, a read
    whose locus lives in another part is indistinguishable from a
    repeat-flooded one, so per-part tier-2 would staircase ~half of every
    batch for nothing.  The LAST part's rescue runs while its tables are
    still HBM-resident (the seed table is dropped first to make room for
    the reverse index); earlier parts reload FM+rev only — with the flat
    layout that is ~3.5 GB instead of a full 8.7 GB part reload.

    The rescue needs per-part reverse indexes (scripts/build_gbp_rev.py);
    without them it is skipped."""
    import jax

    from ..index.files import GenomeIndex as _GI
    from ..models.pipeline import SuffixFilterAligner
    from ..models.pipeline import prefetch_result as _prefetch

    if stats is None:
        stats = {}
    N = reads.shape[0]
    n_batches = -(-N // batch)  # a partial tail batch is padded, not dropped
    padN = n_batches * batch
    if padN != N:
        reads = np.concatenate(
            [reads, np.broadcast_to(reads[:1], (padN - N, reads.shape[1]))]
        )
    best = _Best(padN)
    L = reads.shape[1]
    flat = has_flat(mi.part_dir, mi.n_parts)
    stats["format"] = "flat" if flat else "npz"
    stats["batch_ms"] = []
    stats["tier1_ms"] = 0.0
    stats["n_overflow_rerun"] = 0
    align_s = 0.0
    load_s = 0.0
    last = mi.n_parts - 1

    from concurrent.futures import ThreadPoolExecutor

    pool = ThreadPoolExecutor(1)

    def _stream_part(al, goff, p, deferred=None):
        nonlocal align_s
        t0 = time.time()

        def submit(b):
            return al.align_arrays_submit(
                reads[b * batch : (b + 1) * batch], lengths_row
            )

        # the first submit of a fresh process pays the jit compile of the
        # fused step, so it is recorded separately and reported as compile
        # tax, not align throughput
        pending = submit(0)
        stats.setdefault("first_submit_s", []).append(
            round(time.time() - t0, 1)
        )
        _prefetch(pending)
        for b in range(n_batches):
            tb = time.time()
            nxt = submit(b + 1) if b + 1 < n_batches else None
            _prefetch(nxt)
            ah = al.align_arrays_finish(pending)
            pending = nxt
            dt = (time.time() - tb) * 1e3
            stats["batch_ms"].append(round(dt, 1))
            stats["tier1_ms"] += al.last_stats.get("t_tier1_ms", 0.0)
            stats["n_overflow_rerun"] += al.last_stats.get(
                "n_overflow_fallback", 0
            )
            log(f"part {p} batch {b}: {dt:.0f} ms, stats={al.last_stats}")
            sl = np.arange(b * batch, (b + 1) * batch)
            best.merge(sl, ah, goff)
            if deferred is not None:
                ovun = np.asarray(ah.overflow, bool) & ~np.asarray(
                    ah.mapped, bool
                )
                deferred.append(sl[ovun])
        align_s += time.time() - t0

    def _deferred_tier1(al, goff, p, cohorts):
        """Bigger-budget rerun of the part's overflow-unmapped tail, ONCE
        per part instead of once per batch: a per-batch tier-1 call —
        however small its cohort — queues behind the NEXT pipelined
        batch's primary on the in-order device queue and stretched every
        8k-read gbp batch several-fold on the previous accelerator.  Results
        are per-read deterministic, so deferring changes nothing but the
        schedule; the improve-merge is equivalent to the per-batch
        replace (the cohort is unmapped by construction)."""
        nonlocal align_s
        cohort = np.concatenate(cohorts) if cohorts else np.zeros(0, np.int64)
        stats["n_overflow_rerun"] += int(cohort.size)
        if not cohort.size:
            return
        t0 = time.time()
        fb = al._get_fb()
        CH = fb.FB_CHUNK

        def submit(ch):
            P = CH if cohort.size > CH else max(
                128, 1 << (int(ch.size) - 1).bit_length()
            )
            sel = np.concatenate([ch, np.full(P - ch.size, ch[0], ch.dtype)])
            return fb.align_arrays_submit(reads[sel], np.full(P, L, np.int32))

        chunks = [cohort[o : o + CH] for o in range(0, cohort.size, CH)]
        pending = submit(chunks[0])
        _prefetch(pending)
        for ci, ch in enumerate(chunks):
            nxt = submit(chunks[ci + 1]) if ci + 1 < len(chunks) else None
            _prefetch(nxt)
            ah = fb.align_arrays_finish(pending)
            pending = nxt
            best.merge(ch, ah, goff, m=ch.size)
        dt = time.time() - t0
        align_s += dt
        stats["tier1_ms"] += round(dt * 1e3, 1)
        stats.setdefault("tier1_part_s", []).append(round(dt, 2))
        log(
            f"part {p} deferred tier-1: {cohort.size} overflow-unmapped "
            f"reads in {dt:.2f}s"
        )

    # ---------------------------- flat path ----------------------------
    if flat:
        rescue_planned = all(
            "rev" in json.loads(
                (flat_dir(mi.part_dir, p) / "manifest.json").read_text()
            )
            for p in range(mi.n_parts)
        )
        # background host prefetch: the next part's arrays are np.fromfile'd
        # into RAM while the current part streams (uploading from a cold
        # memmap page-faults; a host-resident array uploads at full speed)
        nxt_arrays = pool.submit(
            _read_part_arrays, mi.part_dir, 0, _STREAM_ARRAYS
        )
        for p in range(mi.n_parts):
            tp = time.time()
            # streaming uses DUMMY FM tables for every part (the seed path
            # never gathers from them) — one executable across parts, no
            # per-part shape split
            fp = load_part_flat(
                mi.part_dir, p, want_seed=True, want_fm=False,
                arrays=nxt_arrays.result(),
            )
            max_hits, max_cands, slack = _part_budgets(fp.n, fp.seed_j)
            al = SuffixFilterAligner(
                _GI(fp.genome, None, None), k=k,
                max_hits_per_piece=max_hits, max_cands=max_cands,
                verify_slack=slack,
                overflow_fallback=False,  # tier-1 runs DEFERRED per part
                device_tables={
                    "fm": fp.fm, "text": fp.text_words,
                    "text_host": fp.text_host,
                },
            )
            al.seed_tab = fp.seed_tab
            al.seed_j = fp.seed_j
            jax.block_until_ready((fp.text_words, fp.seed_tab))
            if p + 1 < mi.n_parts:
                nxt_arrays = pool.submit(
                    _read_part_arrays, mi.part_dir, p + 1, _STREAM_ARRAYS
                )
            elif rescue_planned:
                nxt_arrays = pool.submit(
                    _read_part_arrays, mi.part_dir, last,
                    _FM_ARRAYS + _REV_ARRAYS,
                )
            dt = time.time() - tp
            load_s += dt
            log(
                f"part {p}: flat load+upload in {dt:.1f}s (n={fp.n}, "
                f"max_hits={max_hits}, max_cands={max_cands}, slack={slack})"
            )
            deferred: list = []
            _stream_part(al, fp.global_offset, p, deferred=deferred)
            _deferred_tier1(al, fp.global_offset, p, deferred)
            if p != last:
                del al, fp
                gc.collect()
        stats["stream_align_s"] = round(align_s, 1)

        if debug_out is not None:
            debug_out["pre_rescue"] = (
                best.dist[:N].copy(), best.gpos[:N].copy(),
                best.strand[:N].copy(),
            )

        # ---- deferred tier-2: two-tier staircase rescue, ALL parts
        # co-resident.  Rescue tables are ~3.5 GB/part (FM + rev + text,
        # no seed table), so every part's tables fit HBM together for the
        # 2-part human-scale artifact; loading once and running both
        # tiers avoids a second reload sweep.  Tier A is the PLAIN
        # staircase (cheap) over the whole unmapped cohort; tier B is the
        # narrow-left + mismatch-biased staircase (~4x the per-read cost,
        # measured) over only the reads tier A still could not place —
        # the split cut the warm rescue from ~139 s to ~60 s at 131k
        # reads while keeping mapped 1.0.
        un = np.nonzero(best.dist[:N] > k)[0]
        stats["un_before_rescue"] = int(un.size)
        stats["rescued"] = 0
        if un.size and rescue_planned:
            # drop the streaming tables BEFORE uploading rescue tables
            al.seed_tab = None
            fp.seed_tab = None
            if al._fb is not None:  # the tier-1 copy holds its own seed ref
                al._fb.seed_tab = None
            del al, fp
            gc.collect()
            order = [last] + list(range(mi.n_parts - 1))
            rescue_arrays = nxt_arrays  # prefetched during the last stream
            parts_res = []
            tp = time.time()
            for ri, p in enumerate(order):
                arrs = rescue_arrays.result()
                if ri + 1 < len(order):
                    rescue_arrays = pool.submit(
                        _read_part_arrays, mi.part_dir, order[ri + 1],
                        _FM_ARRAYS + _REV_ARRAYS,
                    )
                fp_r = load_part_flat(
                    mi.part_dir, p, want_seed=False, want_fm=True,
                    arrays=arrs,
                )
                rev = load_rev_flat(mi.part_dir, p, arrays=arrs)
                jax.block_until_ready((fp_r.fm.blocks, rev.blocks))
                parts_res.append((p, fp_r, rev))
            load_s += time.time() - tp
            stats.setdefault("rescue_load_s", 0.0)
            stats["rescue_load_s"] += time.time() - tp

            def _mk(fp_r, rev, narrow):
                return SuffixFilterAligner(
                    _GI(fp_r.genome, None, None), k=k, max_hits_per_piece=8,
                    use_staircase=True, verify_slack=16,
                    overflow_fallback=False, staircase_slots=64,
                    staircase_narrow_left=narrow,
                    device_tables={
                        "fm": fp_r.fm, "text": fp_r.text_words, "rev": rev,
                        "text_host": fp_r.text_host,
                    },
                )

            for tier, narrow in (("A/plain", False), ("B/narrow", True)):
                cohort = np.nonzero(best.dist[:N] > k)[0] if narrow else un
                if not cohort.size:
                    break
                for p, fp_r, rev in parts_res:
                    t0 = time.time()
                    n_r = _rescue_with(
                        _mk(fp_r, rev, narrow), reads, cohort, best,
                        fp_r.global_offset, L,
                    )
                    align_s += time.time() - t0
                    stats.setdefault("rescue_part_s", []).append(
                        round(time.time() - t0, 1)
                    )
                    stats["rescued"] += n_r
                    log(
                        f"rescue tier {tier} part {p}: {cohort.size} "
                        f"unmapped reads in {time.time()-t0:.1f}s, "
                        f"improved {n_r}"
                    )
            del parts_res
            gc.collect()
        else:
            del al, fp
            gc.collect()
        pool.shutdown(wait=False)
        return _finish(best, N, k, align_s, load_s, stats, debug_out)

    # ----------------------------- npz path ----------------------------
    nxt_part = pool.submit(load_part, mi.part_dir, 0)
    for p in range(mi.n_parts):
        tp = time.time()
        # host-side load of part p+1 overlaps part p's align stream below
        # (load_part is pure host npz IO; device upload stays serialized in
        # the aligner constructor on this thread)
        gi, seed_tab, seed_j, goff = nxt_part.result()
        if p + 1 < mi.n_parts:
            nxt_part = pool.submit(load_part, mi.part_dir, p + 1)
        max_hits, max_cands, slack = _part_budgets(gi.fwd.n, seed_j)
        al = SuffixFilterAligner(
            gi, k=k, max_hits_per_piece=max_hits, seed_table=seed_tab,
            seed_j=seed_j, max_cands=max_cands, verify_slack=slack,
        )
        # jnp.asarray uploads are async: force the tables onto the device
        # INSIDE the load window, or the transfer bills to batch 0
        jax.block_until_ready(
            (al.fm.blocks, al.fm.mark_blocks, al.fm.ssa_values,
             al.text_words, al.seed_tab)
        )
        load_s += time.time() - tp
        log(
            f"part {p}: loaded+uploaded in {time.time()-tp:.1f}s "
            f"(n={gi.fwd.n}, max_hits={max_hits}, max_cands={max_cands})"
        )
        _stream_part(al, goff, p)
        # the submit closure in _stream_part closes over ``al`` — drop every
        # reference before the next part's upload, so only one part's
        # device tables are resident at a time
        del al, gi, seed_tab
        gc.collect()
    pool.shutdown(wait=False)
    stats["stream_align_s"] = round(align_s, 1)

    if debug_out is not None:
        debug_out["pre_rescue"] = (
            best.dist[:N].copy(), best.gpos[:N].copy(), best.strand[:N].copy()
        )

    # ---- deferred tier-2: staircase rescue of the still-unmapped tail ----
    un = np.nonzero(best.dist[:N] > k)[0]
    stats["un_before_rescue"] = int(un.size)
    stats["rescued"] = 0
    have_rev = all(
        (Path(mi.part_dir) / f"part{p}_rev.npz").exists()
        for p in range(mi.n_parts)
    )
    if un.size and have_rev:
        for p in range(mi.n_parts):
            tp = time.time()
            gi, _seed, _j, goff = load_part(mi.part_dir, p)
            rev = load_rev(mi.part_dir, p)
            gi = _GI(gi.genome, gi.fwd, rev)
            al2 = SuffixFilterAligner(
                gi, k=k, max_hits_per_piece=8, use_staircase=True,
                verify_slack=16, overflow_fallback=False,
                # full-width pool: a 400k-copy family branches far past the
                # 16-slot default (measured: 1.4% of the stream stayed
                # unmapped to pool truncation); the rescue cohort is a few
                # thousand reads, so the 4x pool costs seconds, not minutes
                staircase_slots=64, staircase_narrow_left=True,
            )
            jax.block_until_ready(
                (al2.fm.blocks, al2.bi.rev.blocks, al2.text_words)
            )
            load_s += time.time() - tp
            stats.setdefault("rescue_load_s", 0.0)
            stats["rescue_load_s"] += time.time() - tp
            t0 = time.time()
            n_r = _rescue_with(al2, reads, un, best, goff, L)
            align_s += time.time() - t0
            stats.setdefault("rescue_part_s", []).append(
                round(time.time() - t0, 1)
            )
            stats["rescued"] += n_r
            log(
                f"rescue part {p}: staircase over {un.size} unmapped reads "
                f"in {time.time()-t0:.1f}s, improved {n_r}"
            )
            del al2, gi, rev
            gc.collect()

    return _finish(best, N, k, align_s, load_s, stats, debug_out)


def _finish(best: _Best, N: int, k: int, align_s, load_s, stats, debug_out):
    if debug_out is not None:
        debug_out["n_good"] = best.n_good[:N].copy()
        debug_out["overflow"] = best.overflow[:N].copy()
        debug_out["stats"] = stats
    stats["align_s"] = round(align_s, 1)
    stats["load_s"] = round(load_s, 1)
    dist, gpos, strand = best.dist[:N], best.gpos[:N], best.strand[:N]
    mapped = dist <= k
    return dist, gpos, strand, mapped, align_s, load_s


def bench_align_stream(
    mi: MultiPartIndex, n_batches: int, batch: int, read_len: int, seed: int,
    log=lambda m: None, stats: dict | None = None, debug_out: dict | None = None,
):
    """Bench driver: loads the prebuilt paired-style read stream (written by
    scripts/build_gbp_index.py next to the parts) and aligns it through the
    multi-part merge path."""
    z = np.load(mi.part_dir / "reads.npz")
    reads, true_gpos, true_strand = z["reads"], z["true_gpos"], z["true_strand"]
    N = min(n_batches * batch, reads.shape[0] - reads.shape[0] % batch)
    reads = reads[:N].astype(np.int8)
    lengths_row = np.full(batch, reads.shape[1], np.int32)

    # warmup/compile on one batch (first part only costs the jit once; the
    # per-part loop reuses the same executable shapes)
    dist, gpos, strand, mapped, align_s, load_s = align_stream_multipart(
        mi, reads, lengths_row, batch, log=log, stats=stats,
        debug_out=debug_out,
    )
    rate = N / align_s
    log(f"multi-part: align {align_s:.1f}s, part load+upload {load_s:.1f}s")
    correct = mapped & (gpos == true_gpos[:N]) & (strand == true_strand[:N])
    if debug_out is not None:
        debug_out["final"] = (dist, gpos, strand)
        debug_out["truth"] = (true_gpos[:N], true_strand[:N])
    return rate, float(mapped.mean()), float(correct.mean()), load_s
