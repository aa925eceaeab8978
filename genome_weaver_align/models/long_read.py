"""Long-read mapping via chunked seeding + diagonal voting (VERDICT r3
missing-#4: every short-read state machine in this package assumes
L <= 256; long reads need a different shape, not bigger buffers).

Method (minimizer-style chunk-and-vote, dense batched form):

1. split the read into fixed ``seg_len`` segments (static shapes — the
   tail shorter than a segment is masked, not ragged);
2. per segment, probe the CSR seed table with the RAREST of a few j-mer
   probes (same rare-seed trick as the short-read path,
   ``suffix_filter.seed_candidates``) -> up to ``hits_per_seg`` genome
   positions -> candidate *diagonals* ``pos - segment_offset``;
3. vote: the true locus shows up as a cluster of near-equal diagonals
   across many segments (indels drift the diagonal by at most the total
   indel length, so clusters are counted within a ``band`` window).
   Random/repeat hits rarely agree across segments.  The winning
   diagonal is found with one sort + windowed neighbour count — no
   host loops, no priority queues;
4. verify: each segment is banded-verified independently against the
   window at its own offset on the winning diagonal (band wide enough
   to absorb accumulated drift), distances summed.  Per-segment
   re-anchoring keeps the band narrow even when total indel drift
   exceeds a short-read band.

This maps arbitrarily long reads with the SAME HBM-resident index and
the same verify kernel as the short-read pipeline.  Base-exact CIGARs
come from ONE whole-read banded affine traceback per mapped read
(``ops.affine``, native engine, vectorised row fill), so per-segment
traceback stitching is unnecessary — the whole-read band (half-width
``kb + band``) is both exact and fast enough on host cores.  Without
``traceback``, ``dist`` is the summed per-segment banded distance (an
upper bound within the drift band).

Reference parity note: the Java reference is a short-read aligner with
no long-read mode (SURVEY.md §2); this module is an
extension requested by the round-3 verdict.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dp as dp_ops
from ..ops import window
from .suffix_filter import NO_CAND, _all_jmers


class LongHits(NamedTuple):
    mapped: np.ndarray  # (B,) bool
    pos: np.ndarray  # (B,) int64 genome start (exact post-traceback, or the
    # winning diagonal when traceback=False)
    strand: np.ndarray  # (B,)
    dist: np.ndarray  # (B,) NM of the traceback alignment (or the summed
    # per-segment banded distance when traceback=False)
    support: np.ndarray  # (B,) segments voting for the winning diagonal
    cigars: dict  # read idx -> CIGAR (traceback=True only)
    aux: dict  # read idx -> (AS, NM) from the affine traceback


@partial(
    jax.jit,
    static_argnames=("j", "seg_len", "hits_per_seg", "n_probes", "band", "kb"),
)
def _chunk_vote_verify(
    offsets: jax.Array,
    positions: jax.Array,
    text_words: jax.Array,
    n_text: int,
    reads: jax.Array,  # (B, L) int32 search codes (N -> 0)
    vreads: jax.Array,  # (B, L) int32 verify codes (N = 4)
    lengths: jax.Array,  # (B,)
    *,
    j: int,
    seg_len: int,
    hits_per_seg: int,
    n_probes: int,
    band: int,
    kb: int,
):
    B, L = reads.shape
    S = L // seg_len  # static segment count (tail segment masked by length)
    seg_starts = jnp.arange(S, dtype=jnp.int32) * seg_len  # (S,)

    # --- 1-2. rare-probe seeding per segment ---------------------------
    jm = _all_jmers(reads, j)  # (B, L)
    # probe positions spread inside each segment (static offsets)
    probe_off = (
        jnp.arange(n_probes, dtype=jnp.int32)
        * max(1, (seg_len - j) // max(1, n_probes))
    )  # (R,)
    pidx = seg_starts[:, None] + probe_off[None, :]  # (S, R)
    pval = jm[:, pidx]  # (B, S, R)
    off2 = offsets[pval[..., None] + jnp.arange(2, dtype=jnp.int32)]
    start_all, end_all = off2[..., 0], off2[..., 1]
    width_all = end_all - start_all
    # a probe whose j-mer runs past the read end must not win the argmin;
    # nor may a ZERO-width bucket (a j-mer absent from the genome = probe
    # crossed an edit): it would beat every live probe and silently
    # unanchor the segment (see suffix_filter.seed_candidates)
    probe_end = pidx[None] + j  # (1, S, R)
    width_all = jnp.where(probe_end <= lengths[:, None, None], width_all, 1 << 30)
    width_all = jnp.where(width_all <= 0, jnp.int32(1 << 30), width_all)
    r_best = jnp.argmin(width_all, axis=2)  # (B, S)

    take = lambda a: jnp.take_along_axis(a, r_best[..., None], axis=2)[..., 0]
    b_start, b_end = take(start_all), take(end_all)
    b_off = jnp.take_along_axis(
        jnp.broadcast_to(pidx[None], (B, S, pidx.shape[1])), r_best[..., None], axis=2
    )[..., 0]  # (B, S) read offset of the chosen probe
    slots = b_start[..., None] + jnp.arange(hits_per_seg, dtype=jnp.int32)
    valid = (slots < b_end[..., None]) & (
        (b_off[..., None] + j) <= lengths[:, None, None]
    )
    hit = positions[jnp.clip(slots, 0, positions.shape[0] - 1)]
    # every diagonal estimates the READ-global start (hit minus the probe's
    # whole-read offset), so cluster width = total indel drift, not read span
    diag3 = jnp.where(valid, hit - b_off[..., None], NO_CAND)  # (B, S, H)
    diag = diag3.reshape(B, S * hits_per_seg)

    # --- 3. diagonal voting --------------------------------------------
    d = jnp.sort(diag, axis=1)  # NO_CAND tail
    # windowed cluster count on the sorted row:
    # votes_i = #{j : d_i <= d_j <= d_i + band}
    real = d != NO_CAND
    votes = jnp.sum(
        (d[:, None, :] >= d[:, :, None]) & (d[:, None, :] <= d[:, :, None] + band),
        axis=2,
    )
    votes = jnp.where(real, votes, 0)
    bi = jnp.argmax(votes, axis=1)
    support = jnp.take_along_axis(votes, bi[:, None], axis=1)[:, 0]
    best_diag = jnp.take_along_axis(d, bi[:, None], axis=1)[:, 0]  # cluster min

    # --- 4. chunked banded verify, each segment re-anchored ------------
    # A segment with its own seed in the winning cluster verifies at its
    # own diagonal (offset error = sub-segment drift only, so the band
    # stays narrow); segments without one (seed destroyed by an edit, or
    # repeat-flooded bucket) fall back to the cluster diagonal.
    member = (diag3 >= best_diag[:, None, None]) & (
        diag3 <= best_diag[:, None, None] + band
    )
    seg_diag = jnp.min(jnp.where(member, diag3, NO_CAND), axis=2)  # (B, S)
    anchored = seg_diag != NO_CAND
    seg_diag = jnp.where(anchored, seg_diag, best_diag[:, None])
    kb_eff = kb  # band half-width of the per-segment verify
    Wseg = seg_len + 3 * kb_eff
    ws = seg_diag + seg_starts[None, :] - 0  # window starts AT the diagonal
    wins = window.gather_windows(text_words, n_text, ws.reshape(-1), Wseg)
    segs = vreads.reshape(B, S, seg_len).reshape(B * S, seg_len).astype(jnp.int8)
    # per-segment effective length (tail segment truncated by the read)
    seg_lens = jnp.clip(
        lengths[:, None] - seg_starts[None, :], 0, seg_len
    ).reshape(-1)
    dists, _ = dp_ops.banded_edit_distance_best(segs, seg_lens, wins, kb_eff)
    # cap an unverifiable segment's contribution (unanchored + drifted past
    # the band) so one bad segment degrades, not destroys, the read score
    cap = jnp.where(seg_lens > 0, jnp.maximum(seg_lens // 4, 2 * kb_eff), 0)
    dists = jnp.where(seg_lens > 0, jnp.minimum(dists, cap), 0)
    dist_total = dists.reshape(B, S).sum(axis=1)
    return best_diag, dist_total, support


class LongReadAligner:
    """Chunked long-read mapper over the shared CSR seed table.

    ``max_edit_frac`` sets the accept threshold: a read maps when its
    summed per-segment banded distance is <= max_edit_frac * length and
    at least ``min_support`` segments voted for the winning diagonal."""

    def __init__(
        self,
        gi,
        seed_table,
        seed_j: int,
        seg_len: int = 128,
        hits_per_seg: int = 4,
        n_probes: int = 4,
        band: int = 48,
        kb: int = 16,
        min_support: int = 3,
        max_edit_frac: float = 0.12,
    ):
        from ..ops import rank

        self.gi = gi
        self.fm = rank.from_host(gi.fwd)
        self.text_words = jnp.asarray(gi.fwd.text_words)
        self.seed_tab = (jnp.asarray(seed_table[0]), jnp.asarray(seed_table[1]))
        self.seed_j = seed_j
        self.seg_len = seg_len
        self.hits_per_seg = hits_per_seg
        self.n_probes = n_probes
        self.band = band
        self.kb = kb
        self.min_support = min_support
        self.max_edit_frac = max_edit_frac

    def align_arrays(
        self, verify_fwd: np.ndarray, lengths: np.ndarray, traceback: bool = True
    ) -> LongHits:
        """Map the batch; with ``traceback`` (default) every mapped read also
        gets an exact CIGAR/POS/AS/NM from one banded affine traceback over
        the whole read (native C++ engine; band sized to absorb the full
        vote-window drift)."""
        from .pipeline import revcomp_verify_batch

        lengths = np.asarray(lengths, dtype=np.int32)
        B, L = verify_fwd.shape
        pad = (-L) % self.seg_len
        if pad:  # pad sits at the END; tail segments mask via seg_lens
            verify_fwd = np.pad(verify_fwd, ((0, 0), (0, pad)), constant_values=4)
        # ragged-aware host revcomp: each row reverses only [0, len), so the
        # rc read also occupies [0, len) and the same segment masking applies
        vrc_np = revcomp_verify_batch(verify_fwd, lengths)
        vf = jnp.asarray(verify_fwd.astype(np.int8)).astype(jnp.int32)
        vrc = jnp.asarray(vrc_np.astype(np.int8)).astype(jnp.int32)
        lens = jnp.asarray(lengths)

        outs = []
        for v in (vf, vrc):
            s = jnp.where(v >= 4, 0, v)
            outs.append(
                _chunk_vote_verify(
                    self.seed_tab[0], self.seed_tab[1], self.text_words,
                    self.fm.n, s, v, lens,
                    j=self.seed_j, seg_len=self.seg_len,
                    hits_per_seg=self.hits_per_seg, n_probes=self.n_probes,
                    band=self.band, kb=self.kb,
                )
            )
        (pf, df, sf_), (pr, dr, sr_) = [tuple(np.asarray(x) for x in o) for o in outs]

        max_d = np.maximum(1, (self.max_edit_frac * lengths)).astype(np.int64)
        # int(): NO_CAND is a jnp scalar, and np_array != jnp_scalar silently
        # promotes the WHOLE host result chain to jax arrays — every scalar
        # access in the traceback loop below then pays a device round-trip,
        # which once took nearly the whole batch
        nc = int(NO_CAND)
        ok_f = (sf_ >= self.min_support) & (df <= max_d) & (pf != nc)
        ok_r = (sr_ >= self.min_support) & (dr <= max_d) & (pr != nc)
        take_r = ok_r & (~ok_f | (dr < df) | ((dr == df) & (pr < pf)))
        mapped = ok_f | ok_r
        pos = np.where(take_r, pr, pf).astype(np.int64)
        dist = np.where(take_r, dr, df).astype(np.int64)
        support = np.where(take_r, sr_, sf_).astype(np.int64)
        strand = take_r.astype(np.int64)
        pos = np.where(mapped, pos, 0)

        cigars: dict[int, str] = {}
        aux: dict[int, tuple[int, int]] = {}
        if traceback and mapped.any():
            from ..ops import affine

            idx = np.nonzero(mapped)[0]
            S = idx.size
            # band half-width: the diagonal estimate is the cluster MINIMUM,
            # so the true start sits up to the FULL `band` to its right (a
            # stray hit can own the minimum) plus kb of sub-segment slack —
            # the affine band must admit starts across that whole range
            kb2 = self.kb + self.band
            lmax = int(lengths[idx].max())
            Wb = lmax + 3 * kb2
            vcodes = np.zeros((S, lmax), dtype=np.int64)
            lens_s = lengths[idx].astype(np.int64)
            ws_all = pos[idx] - kb2
            for t, i in enumerate(idx):
                l = int(lengths[i])
                src = vrc_np if strand[i] else verify_fwd
                vcodes[t, :l] = src[i, :l]
            # vectorised HOST decode for all traceback windows — the old
            # per-read python `extract` loop was ~all of the batch wall
            # time, and a device gather would serialize behind queued
            # mapping batches (see ops.window.gather_windows_host)
            wins = window.gather_windows_host(
                self.gi.fwd.text_words, self.fm.n, ws_all, Wb
            ).astype(np.int64)
            sc, start, cig, nm = affine.affine_banded_batch(
                vcodes, lens_s, wins, kb2
            )
            pos[idx] = np.maximum(ws_all + start, 0)
            dist[idx] = nm
            for t, i in enumerate(idx.tolist()):
                cigars[i] = cig[t]
                aux[i] = (int(sc[t]), int(nm[t]))

        return LongHits(
            mapped=mapped,
            pos=pos,
            strand=strand,
            dist=dist,
            support=support,
            cigars=cigars,
            aux=aux,
        )
