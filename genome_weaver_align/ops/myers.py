"""Myers bit-parallel edit distance (SURVEY.md §2 #11; reference
`BitParallelSmithWaterman.align64`).

Semi-global: computes min over window substrings of edit distance vs. the
whole read, exactly like ``ops.dp.banded_edit_distance`` but with the Myers
1999 bit-vector recurrence: each read is a column bit-vector (PV/MV) packed
into ``ceil(L/32)`` uint32 lanes; one window character costs ~20 word-ops
regardless of read length, with carry/shift propagation across words.

Batched shape: candidate lanes on the batch axis, bit-vector words on a small
trailing axis — pure element-wise traffic, no gathers, no in-row scans
(the carry chain is a static ``nwords``-step unroll).  This is the fast
verify for k of any size; the banded wavefront kernel remains as the
band-limited alternative and CPU oracle.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

ONE = jnp.uint32(1)
ZERO = jnp.uint32(0)
FULL = jnp.uint32(0xFFFFFFFF)


def build_eq(reads: jax.Array, lengths: jax.Array, nwords: int) -> jax.Array:
    """Per-read match masks: (Q, 4, nwords) uint32; bit i of word w set iff
    read[32w+i] == code.  Positions past the read length are zero."""
    Q, L = reads.shape
    pos = jnp.arange(L, dtype=jnp.int32)
    word = pos // 32
    bit = (pos % 32).astype(jnp.uint32)
    in_len = pos[None, :] < lengths[:, None]  # (Q, L)
    out = []
    for c in range(4):
        match = (reads == c) & in_len  # (Q, L)
        bits = jnp.where(match, ONE << bit[None, :], ZERO)
        out.append(_scatter_or(bits, word, nwords))
    return jnp.stack(out, axis=1)


def _scatter_or(bits: jax.Array, word: jax.Array, nwords: int) -> jax.Array:
    """(Q, L) single-bit values OR-ed into (Q, nwords) by word index."""
    Q, L = bits.shape
    acc = []
    for w in range(nwords):
        sel = jnp.where((word == w)[None, :], bits, ZERO)
        acc.append(sel.sum(axis=1, dtype=jnp.uint32))  # disjoint bits: sum == or
    return jnp.stack(acc, axis=1)


def _add_with_carry(a, b):
    """Multi-word unsigned add along the last axis; returns sum words."""
    nwords = a.shape[-1]
    outs = []
    carry = jnp.zeros(a.shape[:-1], jnp.uint32)
    for w in range(nwords):
        s1 = a[..., w] + b[..., w]
        c1 = (s1 < a[..., w]).astype(jnp.uint32)
        s2 = s1 + carry
        c2 = (s2 < s1).astype(jnp.uint32)
        outs.append(s2)
        carry = c1 | c2
    return jnp.stack(outs, axis=-1)


def _shl1_or(x, fill):
    """(x << 1) | fill across the word chain (fill enters bit 0 of word 0)."""
    nwords = x.shape[-1]
    outs = []
    carry_in = fill.astype(jnp.uint32)
    for w in range(nwords):
        outs.append((x[..., w] << ONE) | carry_in)
        carry_in = x[..., w] >> jnp.uint32(31)
    return jnp.stack(outs, axis=-1)


@partial(jax.jit, static_argnames=("nwords", "max_window"))
def myers_semiglobal(
    reads: jax.Array,  # (Q, L) int32 codes; >=4 never matches
    lengths: jax.Array,  # (Q,)
    windows: jax.Array,  # (Q, W) int32 codes; >=4 never matches
    nwords: int,
    max_window: int | None = None,
):
    """Min edit distance of each read vs. any substring of its window."""
    Q, L = reads.shape
    W = windows.shape[1]
    steps = W if max_window is None else max_window
    eq = build_eq(reads, lengths, nwords)  # (Q, 4, nwords)

    # mask of the bit at position len-1 (the score row)
    last = lengths - 1
    last_word = last // 32
    last_bit = (last % 32).astype(jnp.uint32)
    word_idx = jnp.arange(nwords, dtype=jnp.int32)[None, :]
    last_mask = jnp.where(
        word_idx == last_word[:, None], ONE << last_bit[:, None], ZERO
    )  # (Q, nwords)

    pv0 = jnp.full((Q, nwords), FULL)
    mv0 = jnp.zeros((Q, nwords), jnp.uint32)
    score0 = lengths.astype(jnp.int32)
    best0 = lengths.astype(jnp.int32)

    def body(t, state):
        # canonical search-variant recurrence (Myers 1999 / Hyyrö 2003):
        # free text start (D[0][j] = 0) => horizontal shifts fill with 0.
        pv, mv, score, best = state
        c = windows[:, t]  # (Q,)
        peq = jnp.where(
            (c < 4)[:, None, None],
            jnp.take_along_axis(eq, jnp.clip(c, 0, 3)[:, None, None], axis=1),
            ZERO,
        )[:, 0]  # (Q, nwords); Peq = 0 for N/out-of-range chars
        x0 = peq | mv
        d0 = (_add_with_carry(peq & pv, pv) ^ pv) | x0
        hn = pv & d0
        hp = mv | ~(pv | d0)
        score = (
            score
            + jnp.sum(jnp.where((hp & last_mask) != 0, 1, 0), axis=1)
            - jnp.sum(jnp.where((hn & last_mask) != 0, 1, 0), axis=1)
        )
        zero_fill = jnp.zeros((Q,), jnp.uint32)
        xs = _shl1_or(hp, zero_fill)
        mv = xs & d0
        pv = _shl1_or(hn, zero_fill) | ~(xs | d0)
        # semi-global: any window end position is allowed
        best = jnp.minimum(best, score)
        return pv, mv, score, best

    _, _, _, best = jax.lax.fori_loop(0, steps, body, (pv0, mv0, score0, best0))
    return best


@partial(jax.jit, static_argnames=("nwords", "max_window"))
def myers_semiglobal_end(
    reads: jax.Array,  # (Q, L) int32 codes; >=4 never matches
    lengths: jax.Array,  # (Q,)
    windows: jax.Array,  # (Q, W) int32 codes; >=4 never matches
    nwords: int,
    max_window: int | None = None,
):
    """Like ``myers_semiglobal`` but also returns the best end column.

    end (Q,) is the *exclusive* window end position of the first (smallest)
    argmin — the deterministic tie-break shared with the banded engines.
    Used by batched paired-end mate rescue to center a narrow traceback band
    without a per-read device dispatch (VERDICT r1 weak-#6)."""
    Q, L = reads.shape
    W = windows.shape[1]
    steps = W if max_window is None else max_window
    eq = build_eq(reads, lengths, nwords)

    last = lengths - 1
    last_word = last // 32
    last_bit = (last % 32).astype(jnp.uint32)
    word_idx = jnp.arange(nwords, dtype=jnp.int32)[None, :]
    last_mask = jnp.where(
        word_idx == last_word[:, None], ONE << last_bit[:, None], ZERO
    )

    pv0 = jnp.full((Q, nwords), FULL)
    mv0 = jnp.zeros((Q, nwords), jnp.uint32)
    score0 = lengths.astype(jnp.int32)
    best0 = lengths.astype(jnp.int32)
    end0 = jnp.zeros((Q,), jnp.int32)

    def body(t, state):
        pv, mv, score, best, end = state
        c = windows[:, t]
        peq = jnp.where(
            (c < 4)[:, None, None],
            jnp.take_along_axis(eq, jnp.clip(c, 0, 3)[:, None, None], axis=1),
            ZERO,
        )[:, 0]
        x0 = peq | mv
        d0 = (_add_with_carry(peq & pv, pv) ^ pv) | x0
        hn = pv & d0
        hp = mv | ~(pv | d0)
        score = (
            score
            + jnp.sum(jnp.where((hp & last_mask) != 0, 1, 0), axis=1)
            - jnp.sum(jnp.where((hn & last_mask) != 0, 1, 0), axis=1)
        )
        zero_fill = jnp.zeros((Q,), jnp.uint32)
        xs = _shl1_or(hp, zero_fill)
        mv = xs & d0
        pv = _shl1_or(hn, zero_fill) | ~(xs | d0)
        better = score < best  # strict: ties keep the earliest end
        end = jnp.where(better, t + 1, end)
        best = jnp.minimum(best, score)
        return pv, mv, score, best, end

    _, _, _, best, end = jax.lax.fori_loop(
        0, steps, body, (pv0, mv0, score0, best0, end0)
    )
    return best, end
