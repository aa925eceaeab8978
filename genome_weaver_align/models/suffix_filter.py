"""Approximate search: piece partitioning + candidate generation + DP verify
(SURVEY.md §2 #10/#13, §3.3; acceptance configs 3-4).

Method (reference `SuffixFilter`, Kärkkäinen-Na suffix filters): split each
read into ``k+1`` pieces; any alignment with <= k edits leaves at least one
piece exact (pigeonhole), so exact piece occurrences are a complete candidate
generator.  Candidates are verified by the banded wavefront DP
(``ops.dp.banded_edit_distance``).  The staircase bidirectional extension
(which prunes candidates of repetitive pieces before locate) is layered on
top in ``staircase_filter_candidates``.

Batched shape: pieces are searched as extra lockstep lanes of the batched
backward search; candidate loci are dense (B, C) tensors; dedup is a sort +
neighbour-mask; verify runs all (B*C) lanes through the wavefront DP at once.
Repeat overflow (piece interval wider than the locate cap) is flagged per
read, never silently dropped.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dp as dp_ops
from ..ops import rank, window
from ..ops.rank import DeviceFMIndex


class CandidateResult(NamedTuple):
    cand_pos: jax.Array  # (B, C) int32, sorted; NO_CAND where invalid
    n_cands: jax.Array  # (B,)
    overflow: jax.Array  # (B,) bool — some piece interval exceeded the cap


# invalid-candidate sentinel: must sort AFTER every real candidate diagonal
# so the "sorted ascending, NO_CAND tail" invariant (dedup slice, best_hit
# tie-break) holds.  Diagonals reach n - 1 < PART_LIMIT_DEFAULT = 2^31-2^20,
# so this value is strictly above any real position for every device-legal
# index part (the old 2^30 sentinel sat BELOW real positions in parts over
# ~1.07 Gbp and silently displaced them in the max_cands slice).
NO_CAND = jnp.int32(2**31 - 2**20)


def compact_lanes(valid: jax.Array, K: int):
    """Stable indices of the first K True lanes — O(n) cumsum + scatter
    (an argsort here costs O(n log n) and dominated the compaction
    stages).

    Returns (sel (K,) int32 source indices — lanes past the valid count
    point out of range, so scatters *from* them must mask with ``ok``;
    ok (K,) bool; dropped (n,) bool — valid lanes beyond the budget).
    """
    n = valid.shape[0]
    slot = jnp.cumsum(valid.astype(jnp.int32)) - 1
    tgt = jnp.where(valid, slot, K)  # invalid -> out of range, dropped
    sel = jnp.full((K,), n, jnp.int32).at[tgt].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )
    total = slot[-1] + 1 if n else jnp.int32(0)
    ok = jnp.arange(K, dtype=jnp.int32) < total
    sel = jnp.where(ok, sel, 0)  # safe to gather from; mask with ok
    dropped = valid & (slot >= K)
    return sel, ok, dropped


def _piece_bounds(lengths: jax.Array, n_pieces: int):
    """Equal-split piece boundaries [s_i, e_i) per read (reference's split
    scheduling: floor(i*len/p))."""
    i = jnp.arange(n_pieces + 1, dtype=jnp.int32)[None, :]
    return (lengths[:, None] * i) // n_pieces  # (B, n_pieces+1)


@partial(jax.jit, static_argnames=("n_pieces", "max_len", "kmer_j", "kmer_full_cover"))
def piece_interval_search(
    fm: DeviceFMIndex,
    reads: jax.Array,  # (B, L) int32
    lengths: jax.Array,
    n_pieces: int,
    max_len: int | None = None,
    kmer_tab: tuple[jax.Array, jax.Array] | None = None,
    kmer_j: int = 0,
    kmer_full_cover: bool = False,
):
    """Exact backward search of every piece: (B, P) SA intervals.

    With a k-mer table, each piece's last ``kmer_j`` characters resolve with
    one lookup (pieces shorter than kmer_j fall back to the plain loop).
    ``kmer_full_cover=True`` (caller guarantees every piece >= kmer_j) also
    shortens the interval-update loop by kmer_j rounds."""
    B, L = reads.shape
    bounds = _piece_bounds(lengths, n_pieces)
    s, e = bounds[:, :-1], bounds[:, 1:]  # (B, P)
    steps = (L + n_pieces - 1) // n_pieces + 1 if max_len is None else max_len

    if kmer_tab is not None and kmer_j > 0:
        use_tab = (e - s) >= kmer_j  # (B, P)
        idx = jnp.zeros((B, n_pieces), jnp.int32)
        for t in range(kmer_j):
            pos = jnp.clip(e - kmer_j + t, 0)
            c = jnp.take_along_axis(reads, pos, axis=1)
            idx = (idx << 2) | c
        lo0 = jnp.where(use_tab, kmer_tab[0][idx], 0)
        hi0 = jnp.where(use_tab, kmer_tab[1][idx], fm.n + 1)
        skip = jnp.where(use_tab, kmer_j, 0)
    else:
        lo0 = jnp.zeros((B, n_pieces), jnp.int32)
        hi0 = jnp.full((B, n_pieces), fm.n + 1, jnp.int32)
        skip = jnp.zeros((B, n_pieces), jnp.int32)

    def body(t, state):
        lo, hi = state
        j = e - 1 - skip - t  # (B, P)
        active = (j >= s) & (lo < hi)
        c = jnp.take_along_axis(reads, jnp.clip(j, 0), axis=1)
        nlo, nhi = rank.backward_step(fm, c, lo, hi)
        return jnp.where(active, nlo, lo), jnp.where(active, nhi, hi)

    trip = steps - kmer_j if (kmer_tab is not None and kmer_full_cover) else steps
    lo, hi = jax.lax.fori_loop(0, trip, body, (lo0, hi0))
    return lo, hi, s


@partial(jax.jit, static_argnames=(
    "n_pieces", "max_hits", "kmer_j", "kmer_full_cover", "locate_slack", "max_cands"
))
def pigeonhole_candidates(
    fm: DeviceFMIndex,
    reads: jax.Array,
    lengths: jax.Array,
    n_pieces: int,
    max_hits: int = 16,
    kmer_tab=None,
    kmer_j: int = 0,
    kmer_full_cover: bool = False,
    locate_slack: int = 2,
    max_cands: int | None = None,
) -> CandidateResult:
    """Candidate loci from exact piece matches, deduped and sorted.

    Locate is the gather-dominated stage, so only VALID interval rows walk
    the LF chain: rows are batch-compacted (stable argsort on validity) and
    the first ``B * n_pieces * locate_slack`` lanes located; a read whose
    valid row fell beyond the budget is overflow-flagged, never silently
    dropped.  ``max_cands`` caps the candidate axis after dedup (sorted
    ascending, so the slice keeps the smallest loci; > max_cands real
    candidates also flags overflow)."""
    B, L = reads.shape
    lo, hi, s = piece_interval_search(
        fm, reads, lengths, n_pieces,
        kmer_tab=kmer_tab, kmer_j=kmer_j, kmer_full_cover=kmer_full_cover,
    )
    width = hi - lo
    overflow = jnp.any(width > max_hits, axis=1)

    rows = lo[:, :, None] + jnp.arange(max_hits, dtype=jnp.int32)[None, None, :]
    valid = rows < hi[:, :, None]

    rows_flat = jnp.clip(rows, 0, fm.n).reshape(-1)
    valid_flat = valid.reshape(-1)
    K = B * n_pieces * locate_slack
    sel, ok, dropped = compact_lanes(valid_flat, K)
    pos_sel = rank.locate(fm, rows_flat[sel])
    sel_tgt = jnp.where(ok, sel, rows_flat.shape[0])
    pos_flat = jnp.zeros_like(rows_flat).at[sel_tgt].set(pos_sel, mode="drop")
    located = (valid_flat & ~dropped).reshape(rows.shape)
    overflow = overflow | jnp.any(dropped.reshape(B, -1), axis=1)
    pos = pos_flat.reshape(rows.shape)

    cand = jnp.where(valid & located, pos - s[:, :, None], NO_CAND)
    cand = cand.reshape(B, n_pieces * max_hits)
    return _dedupe_cands(cand, overflow, max_cands)


def _dedupe_cands(cand: jax.Array, overflow: jax.Array, max_cands: int | None):
    """Shared candidate tail: sort, neighbour-dedupe, cap at max_cands."""
    B = cand.shape[0]
    cand = jnp.sort(cand, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((B, 1), bool), cand[:, 1:] == cand[:, :-1]], axis=1
    )
    cand = jnp.where(dup, NO_CAND, cand)
    cand = jnp.sort(cand, axis=1)
    n = jnp.sum((cand != NO_CAND).astype(jnp.int32), axis=1)
    if max_cands is not None and max_cands < cand.shape[1]:
        overflow = overflow | (n > max_cands)
        cand = cand[:, :max_cands]
        n = jnp.minimum(n, max_cands)
    return CandidateResult(cand, n, overflow)


# rare-seed probing: j-mer probe positions per pigeonhole piece.  Repeat
# copies flood a FIXED j-mer's bucket (the round-2 repeat-genome bench
# measured 14% of reads lost to budget truncation); a read's private
# variants make SOME j-mer within the piece rare, and ANY j-mer inside an
# error-free piece still matches exactly at the true locus — so picking the
# rarest of a few probes preserves pigeonhole completeness while dodging
# the flood (same idea as minimizer/rare-seed selection in modern aligners).
SEED_PROBES = 4


def _all_jmers(reads: jax.Array, j: int) -> jax.Array:
    """(B, L) int32: the j-mer value starting at every read position.

    Rolling accumulation over j STATIC shifts of the whole read tensor —
    pure elementwise work, no gathers.  (The previous per-probe loop did
    j take_along_axis gathers per probe; with 4 probes that was 104 gathers
    per strand pass and the main cause of the round-2 headline regression —
    VERDICT r2 weak-#3.)  Positions past L - j accumulate zero-padding;
    callers only read positions with a full j-mer in range."""
    B, L = reads.shape
    ext = jnp.concatenate([reads, jnp.zeros((B, j), reads.dtype)], axis=1)
    acc = jnp.zeros((B, L), jnp.int32)
    for t in range(j):
        acc = (acc << 2) | ext[:, t : t + L].astype(jnp.int32)
    return acc


def _seed_probe_idx(reads, s, e, j: int, n_probes: int):
    """j-mer values + start offsets for ``n_probes`` positions per piece.

    Probe r starts at s + floor(avail * r / (R-1)) with avail = e - j - s;
    the last probe is the piece-end-anchored j-mer (the round-1 behavior,
    so n_probes=1 degenerates to it).  Returns (idx, jstart) both
    (B, P, R) int32.  Deterministic: ties in bucket width resolve to the
    lowest probe index in every pipeline."""
    B = reads.shape[0]
    jm = _all_jmers(reads, j)  # (B, L)
    avail = jnp.maximum(e - j - s, 0)  # (B, P)
    starts = []
    for r in range(n_probes):
        if n_probes > 1:
            starts.append(s + (avail * r) // (n_probes - 1))
        else:
            starts.append(s + avail)
    jstart = jnp.stack(starts, axis=2)  # (B, P, R)
    P, R = jstart.shape[1], jstart.shape[2]
    idx = jnp.take_along_axis(jm, jstart.reshape(B, P * R), axis=1).reshape(B, P, R)
    return idx, jstart


@partial(
    jax.jit,
    static_argnames=("n_pieces", "j", "max_hits", "max_cands", "n_probes"),
)
def seed_candidates(
    offsets: jax.Array,  # (4^j + 1,) int32 CSR bucket starts
    positions: jax.Array,  # (n - j + 1,) int32 positions grouped by j-mer
    reads: jax.Array,  # (B, L) int32 search codes (N already mapped to 0)
    lengths: jax.Array,
    n_pieces: int,
    j: int,
    max_hits: int = 16,
    max_cands: int | None = None,
    n_probes: int = SEED_PROBES,
) -> CandidateResult:
    """Candidate loci via the CSR seed table (index.seedtable) — no backward
    search, no LF locate: per piece ``n_probes`` offsets-pair gathers (bucket
    widths) + ONE positions slice gather for the rarest probe.  Complete for
    <=k-edit alignments by pigeonhole (an exact piece implies every j-mer
    inside it is exact); extra diagonals are a verified superset.  Caller
    guarantees every piece length >= j.
    """
    B, L = reads.shape
    bounds = _piece_bounds(lengths, n_pieces)
    s, e = bounds[:, :-1], bounds[:, 1:]  # (B, P)

    idx, jstart = _seed_probe_idx(reads, s, e, j, n_probes)  # (B, P, R)
    off2 = offsets[idx[..., None] + jnp.arange(2, dtype=jnp.int32)]  # (B,P,R,2)
    start_all, end_all = off2[..., 0], off2[..., 1]
    width_all = end_all - start_all
    # a zero-width bucket is a j-mer ABSENT from the genome — i.e. a probe
    # that crossed a read edit.  It must not win the rarest-probe argmin
    # over a live bucket: picking it silently discards the whole piece's
    # candidates (measured on diverged long reads: anchoring collapsed at
    # ~8% divergence because corrupted 13-mers are almost always absent,
    # width 0 < any live width).  Masked to a large sentinel; if EVERY
    # probe is dead the piece still contributes nothing, as before.
    width_all = jnp.where(width_all <= 0, jnp.int32(1 << 30), width_all)
    r_best = jnp.argmin(width_all, axis=2)  # first min: deterministic

    def take(a):
        return jnp.take_along_axis(a, r_best[..., None], axis=2)[..., 0]

    start, end, jst = take(start_all), take(end_all), take(jstart)
    width = end - start
    overflow = jnp.any(width > max_hits, axis=1)

    slots = start[..., None] + jnp.arange(max_hits, dtype=jnp.int32)  # (B, P, H)
    valid = slots < end[..., None]
    hit = positions[jnp.clip(slots, 0, positions.shape[0] - 1)]
    # diagonal: j-mer genome position minus its offset in the read
    cand = jnp.where(valid, hit - jst[..., None], NO_CAND)
    return _dedupe_cands(cand.reshape(B, n_pieces * max_hits), overflow, max_cands)


class VerifyResult(NamedTuple):
    best_pos: jax.Array  # (B,) int32 window-adjusted best locus (cand estimate)
    best_dist: jax.Array  # (B,) int32 (INF if none within threshold)
    best_cand: jax.Array  # (B,) int32 index into cand axis
    n_good: jax.Array  # (B,) candidates within threshold


@partial(jax.jit, static_argnames=("k", "window_width"))
def verify_candidates(
    fm_text_words: jax.Array,
    n_text,
    reads: jax.Array,  # (B, L) int32 — verify codes (N = 4)
    lengths: jax.Array,
    cand_pos: jax.Array,  # (B, C)
    k: int,
    window_width: int,
) -> tuple[jax.Array, jax.Array]:
    """Banded edit distance for every candidate: (B, C) dists (INF invalid)."""
    B, C = cand_pos.shape
    L = reads.shape[1]
    ws = cand_pos - k
    invalid = cand_pos == NO_CAND
    wins = window.gather_windows(
        fm_text_words, n_text, jnp.where(invalid, 0, ws).reshape(-1), window_width
    )
    r = jnp.repeat(reads.astype(jnp.int8), C, axis=0)
    ln = jnp.repeat(lengths, C)
    dist, end_b = dp_ops.banded_edit_distance_best(r, ln, wins, k)
    dist = dist.reshape(B, C)
    dist = jnp.where(invalid, dp_ops.INF, dist)
    return dist, end_b.reshape(B, C)


@partial(jax.jit, static_argnames=("k", "window_width", "nwords"))
def verify_candidates_myers(
    fm_text_words: jax.Array,
    n_text,
    reads: jax.Array,
    lengths: jax.Array,
    cand_pos: jax.Array,
    k: int,
    window_width: int,
    nwords: int,
) -> jax.Array:
    """Myers bit-parallel verify over the same windows (no band limit)."""
    from ..ops import myers as myers_ops

    B, C = cand_pos.shape
    invalid = cand_pos == NO_CAND
    wins = window.gather_windows(
        fm_text_words, n_text, jnp.where(invalid, 0, cand_pos - k).reshape(-1), window_width
    )
    r = jnp.repeat(reads.astype(jnp.int32), C, axis=0)
    ln = jnp.repeat(lengths, C)
    dist = myers_ops.myers_semiglobal(r, ln, wins.astype(jnp.int32), nwords)
    return jnp.where(invalid, dp_ops.INF, dist.reshape(B, C))


@partial(jax.jit, static_argnames=("k",))
def offset_hamming(
    text_words: jax.Array,
    n_text,
    reads: jax.Array,  # (B, L) verify codes
    lengths: jax.Array,
    cand_pos: jax.Array,  # (B,) chosen best candidate estimate
    k: int,
):
    """Hamming distance of each read vs window[cand-k+o : ...] for o in
    [0, 2k].  If min == the edit distance, the alignment is pure
    substitutions: CIGAR is '<L>M' with start cand-k+argmin — no traceback
    needed (the fast path for substitution-dominated read streams)."""
    B, L = reads.shape
    W = L + 2 * k + 1
    wins = window.gather_windows(text_words, n_text, cand_pos - k, W)
    hams = []
    for o in range(2 * k + 1):
        hams.append(dp_ops.hamming_distance(reads, lengths, wins, o))
    h = jnp.stack(hams, axis=1)  # (B, 2k+1)
    o_min = jnp.argmin(h, axis=1).astype(jnp.int32)
    return jnp.min(h, axis=1), o_min


@partial(jax.jit, static_argnames=("k", "window_width", "slack"))
def verify_candidates_compact(
    text_words: jax.Array,
    n_text,
    reads: jax.Array,  # (B, L) verify codes (N = 4)
    lengths: jax.Array,
    cand_pos: jax.Array,  # (B, C) sorted, NO_CAND tail
    k: int,
    window_width: int,
    slack: int = 6,
):
    """Banded verify over batch-compacted candidate lanes.

    Candidate counts are long-tailed (most reads have ~2-4 after dedup, a
    few have many), so a hard per-read cap either wastes verify lanes or
    drops true candidates.  Instead the whole batch shares a budget of
    ``B * slack`` lanes: valid candidates are compacted to the front
    (stable argsort on validity — the same dense-work-queue trick as the
    FM locate path) and only those lanes run the wavefront DP.  A read
    whose candidates fall beyond the budget is overflow-flagged, never
    silently dropped.

    Returns (dist (K,), cp (K,), rid (K,), overflow (B,)) — compacted
    lanes with their read ids, for ``best_hit_compact``.
    """
    B, C = cand_pos.shape
    flat = cand_pos.reshape(-1)
    valid = flat != NO_CAND
    K = B * slack
    sel, ok, dropped = compact_lanes(valid, K)
    rid = (sel // C).astype(jnp.int32)
    cp = flat[sel]
    wins = window.gather_windows(
        text_words, n_text, jnp.where(ok, cp - k, 0), window_width
    )
    r = reads.astype(jnp.int8)[rid]
    ln = lengths[rid]
    dist, _ = dp_ops.banded_edit_distance_best(r, ln, wins, k)
    dist = jnp.where(ok, dist, dp_ops.INF)
    overflow = jnp.any(dropped.reshape(B, C), axis=1)
    return dist, cp, rid, overflow


@partial(jax.jit, static_argnames=("k", "n_reads"))
def best_hit_compact(
    rid: jax.Array, cp: jax.Array, dist: jax.Array, k: int, n_reads: int
) -> VerifyResult:
    """Deterministic per-read best over compacted lanes via scatter-min.

    Order matches ``best_hit``: lexicographic (dist, pos), dist <= k only.
    Two scatter-mins avoid packing (dist, pos) into one word, so there is
    no genome-size limit.
    """
    good = dist <= k
    dkey = jnp.where(good, dist, dp_ops.INF)
    best_dist = jnp.full((n_reads,), dp_ops.INF, dist.dtype).at[rid].min(dkey)
    pkey = jnp.where(good & (dist == best_dist[rid]), cp, NO_CAND)
    best_pos = jnp.full((n_reads,), NO_CAND, cp.dtype).at[rid].min(pkey)
    n_good = jnp.zeros((n_reads,), jnp.int32).at[rid].add(good.astype(jnp.int32))
    has = n_good > 0
    return VerifyResult(
        jnp.where(has, best_pos, -1),
        jnp.where(has, best_dist, dp_ops.INF),
        jnp.zeros((n_reads,), jnp.int32),  # lane index is meaningless here
        n_good,
    )


@partial(jax.jit, static_argnames=("k",))
def best_hit(cand_pos: jax.Array, dist: jax.Array, k: int) -> VerifyResult:
    """Deterministic best: min (dist, pos); only dist <= k counts.

    ``cand_pos`` rows are sorted ascending (pigeonhole_candidates), so
    argmin's first-match tie-break picks the smallest position among equal
    distances — device-count-independent ordering for bit-identical SAM.
    """
    good = dist <= k
    key = jnp.where(good, dist, dp_ops.INF)
    bi = jnp.argmin(key, axis=1).astype(jnp.int32)
    bb = jnp.take_along_axis(dist, bi[:, None], axis=1)[:, 0]
    bp = jnp.take_along_axis(cand_pos, bi[:, None], axis=1)[:, 0]
    n_good = jnp.sum(good.astype(jnp.int32), axis=1)
    has = n_good > 0
    return VerifyResult(
        jnp.where(has, bp, -1),
        jnp.where(has, bb, dp_ops.INF),
        bi,
        n_good,
    )
