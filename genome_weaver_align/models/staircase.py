"""Staircase suffix-filter search (SURVEY.md §2 #10; reference `SuffixFilter`,
Kärkkäinen–Na suffix filters).

For each piece i of the k+1 partition, match the read *suffix* starting at
piece i: piece i exactly (backward-built bidirectional spine), then forward
through pieces i+1..k under the staircase budget — cumulative mismatches
within pieces i..m must stay <= m - i.  Every locus with <= k substitutions
passes at least one piece's staircase (suffix-filter theorem), so this is a
complete *filter* for substitution-k matching with far fewer false
candidates than plain pigeonhole (piece-only) matching.  Indel-containing
alignments are NOT guaranteed to pass (a frame shift breaks the Hamming
suffix): edit-distance configs use ``pigeonhole_candidates`` for
completeness; the reference made the same split (bit-parallel mismatch NFA
in search, indels scored in the DP verify stage).

Batched shape (P4): the reference's priority queue of `SearchState`s becomes a
dense (B, S) pool of (bidirectional interval, mismatch-count) lanes; each
step expands every lane into its 4 children with ONE `extend_forward_all4`
(two occ_all4 gathers), masks children by the staircase budget, and compacts
the 4S pool back to S slots by liveness.  Overflow is flagged per read.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import bidirectional as bd
from .bidirectional import BiInterval, DeviceBiIndex
from .suffix_filter import NO_CAND, CandidateResult, _piece_bounds
from ..ops import rank


class Pool(NamedTuple):
    iv: BiInterval  # (B, S) synchronized intervals
    mm: jax.Array  # (B, S) int32 mismatch counts
    overflow: jax.Array  # (B,) bool


def _compact_pool(iv: BiInterval, mm, n_slots: int):
    """Keep the first n_slots live lanes (stable), count total live.

    Gather formulation: src[b, s] = index of the (s+1)-th live lane, found
    by binary search on the per-row liveness cumsum; then ONE take per
    field.  This replaced the cumsum+row-scatter version, whose five
    (B, 4S) scatters dominated the forward loop on the previous accelerator
    while ``extend_forward_all4``'s gathers were noise (scatters serialized
    there; gathers vectorize).  The earlier stable argsort was worse still.  Semantics identical: stable order, dead slots zeroed,
    ``live`` = total live lanes (may exceed n_slots — caller's overflow
    flag)."""
    B, S4 = mm.shape
    alive = iv.hi > iv.lo
    cs = jnp.cumsum(alive.astype(jnp.int32), axis=1)  # (B, S4) nondecreasing
    live = cs[:, -1]
    targets = jnp.arange(1, n_slots + 1, dtype=jnp.int32)
    src = jax.vmap(lambda row: jnp.searchsorted(row, targets, side="left"))(cs)
    src = jnp.clip(src, 0, S4 - 1)
    ok = targets[None, :] <= live[:, None]

    def take(field):
        g = jnp.take_along_axis(field, src, axis=1)
        return jnp.where(ok, g, 0)

    packed = BiInterval(take(iv.lo), take(iv.hi), take(iv.rlo), take(iv.rhi))
    return packed, take(mm), live


@partial(
    jax.jit,
    static_argnames=(
        "k", "n_slots", "hits_per_state", "keep", "max_len", "narrow_left"
    ),
)
def staircase_filter_candidates(
    bi: DeviceBiIndex,
    reads: jax.Array,  # (B, L) int32
    lengths: jax.Array,
    k: int,
    n_slots: int = 16,
    hits_per_state: int = 4,
    keep: int = 8,
    max_hits: int | None = None,  # accepted for API parity; unused
    max_len: int | None = None,
    narrow_left: bool = False,  # after the suffix staircase, extend every
    # surviving state LEFT through the pieces before its anchor under the
    # full k budget (the reference's bidirectional narrowing).  Without
    # it, a last-piece lane in a high-copy repeat family ends as a WIDE
    # interval (every copy matching the suffix) of which only
    # hits_per_state rows are sampled — measured on the gbp bench, the
    # entire unmapped tail (112/32768) was this sampling miss, and pool
    # size 64 vs 128 changed nothing.  Narrowing shrinks those intervals
    # to whole-read matches at ~+2L/3 sequential steps; ON for the
    # completeness-critical multipart rescue, OFF where truncation is
    # acceptable and flagged (repeat tier-2).
) -> CandidateResult:
    B, L = reads.shape
    Lb = L if max_len is None else max_len
    P = k + 1
    # Lane-folded pieces: the P per-piece searches run as a leading lane
    # axis, not sequential Python loops.  The staircase is DEPTH-bound at
    # fallback-cohort widths (every extension step is a latency-priced
    # occ_all4 round), so folding P spine loops into one and the P forward
    # loops into one cuts the sequential step count from
    # sum_i(spine + fwd_i) ~= (2P-1)/P * L  to  spine + max_i fwd_i
    # ~= L  — a ~2x wall-time cut for k=2 on top of the caller's
    # fwd+rc strand stacking (VERDICT r3 weak-#4).
    spine_steps = -(-Lb // P)
    fwd_steps = -(-(Lb * (P - 1)) // P)  # piece 0's bound covers all lanes
    bounds = _piece_bounds(lengths, P)  # (B, P+1)
    n = bi.fwd.n

    s_pb = bounds[:, :-1].T  # (P, B) piece starts
    e_pb = bounds[:, 1:].T  # (P, B) piece ends
    lane_piece = jnp.arange(P, dtype=jnp.int32)[:, None]  # (P, 1)

    def char_at(j):  # j (P, B) -> codes (P, B)
        jt = jnp.clip(j, 0).T
        return jnp.take_along_axis(reads, jt, axis=1).T

    # ---- spines: every piece built backward simultaneously
    def spine_body(t, st):
        j = e_pb - 1 - t
        active = j >= s_pb
        ext = bd.extend_backward(bi, st, char_at(j))
        return BiInterval(*[jnp.where(active, a, b) for a, b in zip(ext, st)])

    spine = jax.lax.fori_loop(
        0, spine_steps, spine_body, bd.init_interval(n, (P, B))
    )

    # ---- pool init: slot 0 = spine, mm 0
    slot0 = jnp.arange(n_slots, dtype=jnp.int32)[None, None, :] == 0
    iv = BiInterval(*[jnp.where(slot0, f[:, :, None], 0) for f in spine])
    mm = jnp.zeros((P, B, n_slots), jnp.int32)
    overflow_pb = jnp.zeros((P, B), bool)

    def compact(iv4, mm4, slots):
        flat_iv = BiInterval(*[f.reshape(P * B, -1) for f in iv4])
        p_iv, p_mm, live = _compact_pool(flat_iv, mm4.reshape(P * B, -1), slots)
        return (
            BiInterval(*[f.reshape(P, B, slots) for f in p_iv]),
            p_mm.reshape(P, B, slots),
            live.reshape(P, B),
        )

    def expand_step(iv, mm, ovf, c, budget, active, extend_all4):
        """One masked all-4 expansion + mismatch-biased compaction.

        Mismatch-biased retention (r5): compaction keeps the FIRST
        n_slots live lanes, so lane ORDER decides who survives overflow.
        The natural (parent-major, code-order) layout drops states
        blindly — inside a 100k-copy repeat family that was measured to
        drop the read's own low-mismatch state while keeping mismatch
        siblings.  Reorder each parent's children exact-first, then lay
        the pool out CHILD-RANK-major, so every exact extension precedes
        every mismatch extension; truncation then discards highest-mm
        states first.  A full mm sort would be exact but argsort
        dominated this loop when tried (r4); the block bias is one cheap
        gather."""
        all4 = extend_all4(bi, iv)  # fields (P, B, S, 4)
        codes = jnp.arange(4, dtype=jnp.int32)[None, None, None, :]
        child_mm = mm[..., None] + (codes != c[..., None, None]).astype(jnp.int32)
        ok = child_mm <= budget[..., None, None]
        pool_iv = BiInterval(
            jnp.where(ok, all4.lo, 0),
            jnp.where(ok, all4.hi, 0),
            all4.rlo,
            all4.rhi,
        )
        if narrow_left:
            # the per-field reorder+transpose about doubled the step cost on
            # the previous accelerator's repeat tier-2, so it is tied to
            # the completeness-critical narrowing mode; the plain layout's
            # blind truncation is acceptable where overflow is flagged
            perm = jnp.argsort(
                (codes[..., 0, :] != c[..., None]).astype(jnp.int32) * 4
                + jnp.arange(4, dtype=jnp.int32)[None, None, :],
                axis=-1,
            )  # (P, B, 4) — exact child first, then code order
            pb4 = perm[:, :, None, :]

            def reorder(f):  # (P, B, S, 4) -> (P, B, 4*S), child-rank-major
                g = jnp.take_along_axis(
                    f, jnp.broadcast_to(pb4, f.shape), axis=-1
                )
                return g.transpose(0, 1, 3, 2)

            pool_iv = BiInterval(*[reorder(f) for f in pool_iv])
            child_mm = reorder(child_mm)
        new_iv, new_mm, live = compact(pool_iv, child_mm, n_slots)
        ovf = ovf | (active & (live > n_slots))
        out_iv = BiInterval(
            *[jnp.where(active[..., None], a, b) for a, b in zip(new_iv, iv)]
        )
        out_mm = jnp.where(active[..., None], new_mm, mm)
        return out_iv, out_mm, ovf

    def fwd_body(t, carry):
        iv, mm, ovf = carry
        j = e_pb + t  # (P, B)
        active = j < lengths[None, :]
        c = char_at(j)
        jcap = jnp.minimum(j, lengths[None, :] - 1)
        piece_of_j = (
            jnp.sum((bounds[None, :, :] <= jcap[:, :, None]).astype(jnp.int32), axis=2)
            - 1
        )  # (P, B)
        budget = piece_of_j - lane_piece
        return expand_step(iv, mm, ovf, c, budget, active, bd.extend_forward_all4)

    iv, mm, overflow_pb = jax.lax.fori_loop(
        0, fwd_steps, fwd_body, (iv, mm, overflow_pb)
    )

    if narrow_left:
        # leftward narrowing: extend every surviving state back through
        # the pieces BEFORE its anchor piece under the full k budget, so
        # final intervals hold whole-read (not suffix) matches
        bwd_steps = -(-(Lb * (P - 1)) // P)  # lane P-1 walks the most
        full_budget = jnp.full((P, B), k, jnp.int32)

        def bwd_body(t, carry):
            iv, mm, ovf = carry
            j = s_pb - 1 - t  # (P, B)
            active = j >= 0
            c = char_at(j)
            return expand_step(
                iv, mm, ovf, c, full_budget, active, bd.extend_backward_all4
            )

        iv, mm, overflow_pb = jax.lax.fori_loop(
            0, bwd_steps, bwd_body, (iv, mm, overflow_pb)
        )

    # final states: compact to the keep-window before the (costly) locate
    iv, mm, live_final = compact(iv, mm, keep)
    overflow_pb = overflow_pb | (live_final > keep)

    # -> candidate loci (read start = occ - s_i), ONE locate for all pieces.
    # Dead lanes are pinned to row 0, not clipped garbage: the sparse-SA
    # LF walk on wild rows scatters its gathers across the whole index;
    # row 0 keeps them cache-resident.
    rows = iv.lo[..., None] + jnp.arange(hits_per_state, dtype=jnp.int32)
    valid = rows < iv.hi[..., None]
    rows = jnp.where(valid, rows, 0)
    pos = rank.locate(bi.fwd, jnp.clip(rows, 0, n).reshape(-1)).reshape(rows.shape)
    # narrowed states span the WHOLE read, so their occurrence IS the read
    # start; suffix-only states start at their piece
    cand_off = jnp.zeros_like(s_pb) if narrow_left else s_pb
    cand = jnp.where(valid, pos - cand_off[..., None, None], NO_CAND)  # (P,B,keep,H)
    overflow_pb = overflow_pb | jnp.any((iv.hi - iv.lo) > hits_per_state, axis=2)
    overflow = jnp.any(overflow_pb, axis=0)

    cand = cand.transpose(1, 0, 2, 3).reshape(B, P * keep * hits_per_state)
    cand = jnp.sort(cand, axis=1)
    dup = jnp.concatenate([jnp.zeros((B, 1), bool), cand[:, 1:] == cand[:, :-1]], axis=1)
    cand = jnp.sort(jnp.where(dup, NO_CAND, cand), axis=1)
    n_c = jnp.sum((cand != NO_CAND).astype(jnp.int32), axis=1)
    return CandidateResult(cand, n_c, overflow)
