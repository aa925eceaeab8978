"""Genome window gather: packed text in HBM -> per-candidate code windows.

Used by the DP verify stage: each candidate locus extracts W codes starting
at ``ws`` from the 2-bit packed text.  Out-of-range positions return code 4
(never matches, counts as an edit) so callers need no masks.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("width",))
def gather_windows(
    text_words: jax.Array,  # (nw,) uint32 packed text
    n: int | jax.Array,  # text length in bases
    starts: jax.Array,  # (Q,) int32 window starts (may be negative)
    width: int,
):
    """-> (Q, width) int8 codes, 4 where out of range.

    Gathers whole 16-base words (width/16 + 2 per query) and unpacks with a
    static word-select loop — ~16x fewer gather elements than a per-base
    gather, which dominated the verify stage.  int8 output keeps the
    (B*C, W) window tensor 4x smaller in HBM."""
    nw = width // 16 + 2
    w0 = starts >> 4  # first word per query (floor for negatives too)
    widx = w0[:, None] + jnp.arange(nw, dtype=jnp.int32)[None, :]
    n_words = text_words.shape[0]
    words = text_words[jnp.clip(widx, 0, n_words - 1)]  # (Q, nw) word gather

    idx = starts[:, None] + jnp.arange(width, dtype=jnp.int32)[None, :]
    valid = (idx >= 0) & (idx < n)
    local_w = (idx >> 4) - w0[:, None]  # in [0, nw)
    shift = (2 * (idx & 15)).astype(jnp.uint32)
    codes = jnp.zeros(idx.shape, jnp.uint32)
    for wslot in range(nw):  # static select: no second gather
        codes = jnp.where(
            local_w == wslot, (words[:, wslot][:, None] >> shift), codes
        )
    codes = (codes & jnp.uint32(3)).astype(jnp.int8)
    return jnp.where(valid, codes, jnp.int8(4))


def gather_windows_host(text_words, n: int, starts, width: int):
    """NumPy twin of ``gather_windows`` for small host-side cohorts.

    The slow-path CIGAR traceback needs a few dozen windows per batch;
    issuing a DEVICE gather for them from the finish path enqueues a tiny
    op BEHIND the next pipelined batch's compute on the in-order queue,
    so the finish waits for that whole batch.  Decoding the few
    windows from the packed words on host costs microseconds and keeps
    the device queue untouched.  Same semantics: (Q, width) codes, 4 out
    of range."""
    import numpy as np

    starts = np.asarray(starts, dtype=np.int64)
    nw = width // 16 + 2
    w0 = starts >> 4
    widx = w0[:, None] + np.arange(nw, dtype=np.int64)[None, :]
    words = np.asarray(text_words)[np.clip(widx, 0, len(text_words) - 1)]
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, None, :]
    codes = ((words[:, :, None] >> shifts) & 3).astype(np.int8)
    codes = codes.reshape(starts.size, nw * 16)
    off = (starts - (w0 << 4)).astype(np.int64)
    cols = off[:, None] + np.arange(width, dtype=np.int64)[None, :]
    out = np.take_along_axis(codes, cols, axis=1)
    pos = starts[:, None] + np.arange(width, dtype=np.int64)[None, :]
    return np.where((pos >= 0) & (pos < n), out, np.int8(4))
