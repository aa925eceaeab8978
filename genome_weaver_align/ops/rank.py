"""Device-side FM-index rank/occ and LF primitives (SURVEY.md §2 #6/P6).

This is the hot lookup of the whole aligner (reference
`OccurrenceCountTable.occ` — the checkpoint + popcount scan), rebuilt as
batched JAX ops: every query is ONE fused-row gather + XOR/popcount reduce,
vectorised over a read-cohort axis.

Device layout (the design point, SURVEY.md §7): BWT words and their
occurrence checkpoint are *interleaved* into one 48-byte row per 128-base
block —

    row b (12 x uint32): [ 8 bwt words | occ_cp[b, A..T] bitcast ]

so occ(c, k) costs a single aligned row gather; the partial count is an
in-register XOR/popcount over the 8 words.  Bit layout matches
``utils.packing``/``index.build``; tests assert bit-identical results vs.
the NumPy oracle.

All device indices are int32 (single index <= 2^31-1 elements, see
``utils.larray``); words are uint32 with 16 bases each.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..index.build import BLOCK_BASES, WORDS_PER_BLOCK, FMIndexData
from ..utils.larray import check_device_indexable

_PAIR = jnp.uint32(0x55555555)
_FULL = jnp.uint32(0xFFFFFFFF)

FUSED_WIDTH = WORDS_PER_BLOCK + 4  # 8 bwt words + 4 checkpoint lanes

MARK_BLOCK_BITS = 128
MARK_WORDS_PER_BLOCK = MARK_BLOCK_BITS // 32


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DeviceFMIndex:
    """HBM-resident FM-index tables (one strand direction)."""

    blocks: jax.Array  # (nb+1, 12) uint32 fused rows (see module docstring)
    C: jax.Array  # (5,) int32
    primary: jax.Array  # () int32 — row of $ in sentinel-inclusive BWT
    mark_blocks: jax.Array  # (mb, 4) uint32 — sparse-SA row marks
    mark_cp: jax.Array  # (mb+1,) int32 — rank1 checkpoints over marks
    ssa_values: jax.Array  # (n_samples,) int32 — sampled SA values, row order
    n: int = dataclasses.field(metadata=dict(static=True))
    sample_rate: int = dataclasses.field(metadata=dict(static=True))
    full_sa: jax.Array | None = None  # optional (n+1,) int32 — locate in ONE gather


def fuse_blocks(bwt_words: np.ndarray, occ_cp: np.ndarray) -> np.ndarray:
    """Host-side interleave: (nb+1, 8) words + (nb+1, 4) cp -> (nb+1, 12)."""
    nb = occ_cp.shape[0]
    words = bwt_words.reshape(nb, WORDS_PER_BLOCK)
    fused = np.empty((nb, FUSED_WIDTH), dtype=np.uint32)
    fused[:, :WORDS_PER_BLOCK] = words
    fused[:, WORDS_PER_BLOCK:] = occ_cp.astype(np.int32).view(np.uint32)
    return fused


def from_host(fm: FMIndexData) -> DeviceFMIndex:
    # every device-side lookup (LF, locate, occ) indexes with int32
    check_device_indexable(fm.n + 1, "FM index")
    marks = fm.ssa_marks
    mw = marks._wpad
    mb = mw.size // MARK_WORDS_PER_BLOCK
    return DeviceFMIndex(
        blocks=jnp.asarray(fuse_blocks(fm.bwt_words, fm.occ_cp)),
        C=jnp.asarray(fm.C.astype(np.int32)),
        primary=jnp.asarray(np.int32(fm.primary)),
        mark_blocks=jnp.asarray(mw.reshape(mb, MARK_WORDS_PER_BLOCK)),
        mark_cp=jnp.asarray(marks.checkpoints.astype(np.int32)),
        ssa_values=jnp.asarray(fm.ssa_values.astype(np.int32)),
        n=int(fm.n),
        sample_rate=int(fm.sample_rate),
        full_sa=None if fm.full_sa is None else jnp.asarray(fm.full_sa),
    )


def from_arrays(
    blocks: np.ndarray,
    C: np.ndarray,
    primary: int,
    mark_blocks: np.ndarray,
    mark_cp: np.ndarray,
    ssa_values: np.ndarray,
    n: int,
    sample_rate: int,
    full_sa: np.ndarray | None = None,
) -> DeviceFMIndex:
    """DeviceFMIndex straight from device-ready host arrays (memmaps OK).

    The flat multi-part layout (index.multipart_io) stores exactly these
    arrays on disk, so a Gbp part loads with ZERO host transformation:
    np.memmap -> jnp.asarray page-in/upload.  ``from_host`` remains the
    build-time path; both produce bit-identical device tables
    (tests/test_multipart_io.py pins this)."""
    check_device_indexable(int(n) + 1, "FM index")
    return DeviceFMIndex(
        blocks=jnp.asarray(blocks),
        C=jnp.asarray(np.asarray(C, dtype=np.int32)),
        primary=jnp.asarray(np.int32(primary)),
        mark_blocks=jnp.asarray(mark_blocks),
        mark_cp=jnp.asarray(mark_cp),
        ssa_values=jnp.asarray(ssa_values),
        n=int(n),
        sample_rate=int(sample_rate),
        full_sa=None if full_sa is None else jnp.asarray(full_sa),
    )


def _pair_masks(r: jax.Array) -> jax.Array:
    """(...,) base offsets in [0, 128] -> (..., 8) uint32 pair masks.

    Word j of a block may count min(max(r - 16j, 0), 16) leading bases; the
    mask covers exactly those 2-bit slots.  Shift-by-32 is avoided by
    selecting on the zero case.
    """
    allowed = jnp.clip(
        r[..., None] - 16 * jnp.arange(WORDS_PER_BLOCK, dtype=r.dtype),
        0,
        16,
    ).astype(jnp.uint32)
    shift = 2 * allowed  # 0..32
    safe = jnp.clip(32 - shift, 0, 31).astype(jnp.uint32)
    return jnp.where(shift == 0, jnp.uint32(0), _FULL >> safe)


def _match_counts(words: jax.Array, code: jax.Array, pair_masks: jax.Array) -> jax.Array:
    """#bases equal to ``code`` within the masked slots; sums last axis."""
    x = words ^ (code[..., None].astype(jnp.uint32) * _PAIR)
    mm = ~(x | (x >> jnp.uint32(1))) & _PAIR & pair_masks
    return jnp.sum(jax.lax.population_count(mm).astype(jnp.int32), axis=-1)


def _row_split(fm: DeviceFMIndex, k: jax.Array):
    """Fused-row fetch for sentinel-inclusive coordinates k."""
    k_adj = (k - (k > fm.primary)).astype(jnp.int32)
    b = k_adj // BLOCK_BASES
    r = k_adj - b * BLOCK_BASES
    row = fm.blocks[b]  # (..., 12) — ONE gather
    words = row[..., :WORDS_PER_BLOCK]
    cp = jax.lax.bitcast_convert_type(row[..., WORDS_PER_BLOCK:], jnp.int32)
    return words, cp, r


def occ_codes(fm: DeviceFMIndex, codes: jax.Array, k: jax.Array) -> jax.Array:
    """occ$(codes[i], k[i]) for each lane i — sentinel-inclusive coordinates."""
    words, cp, r = _row_split(fm, k)
    base = jnp.take_along_axis(cp, codes[..., None].astype(jnp.int32), axis=-1)[..., 0]
    return base + _match_counts(words, codes, _pair_masks(r))


def occ_all4(fm: DeviceFMIndex, k: jax.Array) -> jax.Array:
    """occ$(c, k) for all four codes: (...,) -> (..., 4)."""
    words, cp, r = _row_split(fm, k)
    masks = _pair_masks(r)
    counts = [
        _match_counts(words, jnp.full(k.shape, c, jnp.int32), masks) for c in range(4)
    ]
    return cp + jnp.stack(counts, axis=-1)


def backward_step(
    fm: DeviceFMIndex, codes: jax.Array, lo: jax.Array, hi: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """One batched backward-search interval update (call stack SURVEY.md §3.2).

    lo and hi are fetched in a single stacked gather (one wide gather
    instead of two half-size ones)."""
    both = occ_codes(
        fm,
        jnp.concatenate([codes, codes], axis=0),
        jnp.concatenate([lo, hi], axis=0),
    )
    occ_lo, occ_hi = jnp.split(both, 2, axis=0)
    Cc = fm.C[codes.astype(jnp.int32)]
    return Cc + occ_lo, Cc + occ_hi


def bwt_char(fm: DeviceFMIndex, i: jax.Array) -> jax.Array:
    """BWT code at sentinel-inclusive row(s) i (caller avoids the primary row)."""
    idx = (i - (i > fm.primary)).astype(jnp.int32)
    w = fm.blocks[idx // BLOCK_BASES, (idx % BLOCK_BASES) // 16]
    return ((w >> (2 * (idx % 16)).astype(jnp.uint32)) & jnp.uint32(3)).astype(jnp.int32)


def lf(fm: DeviceFMIndex, i: jax.Array) -> jax.Array:
    c = bwt_char(fm, i)
    return fm.C[c] + occ_codes(fm, c, i)


def lf_fused(fm: DeviceFMIndex, i: jax.Array) -> jax.Array:
    """LF with a single row gather: char and occ from the same fused row."""
    k_adj = (i - (i > fm.primary)).astype(jnp.int32)
    b = k_adj // BLOCK_BASES
    r = k_adj - b * BLOCK_BASES
    row = fm.blocks[b]
    words = row[..., :WORDS_PER_BLOCK]
    cp = jax.lax.bitcast_convert_type(row[..., WORDS_PER_BLOCK:], jnp.int32)
    w = jnp.take_along_axis(words, (r // 16)[..., None], axis=-1)[..., 0]
    c = ((w >> (2 * (r % 16)).astype(jnp.uint32)) & jnp.uint32(3)).astype(jnp.int32)
    base = jnp.take_along_axis(cp, c[..., None], axis=-1)[..., 0]
    return fm.C[c] + base + _match_counts(words, c, _pair_masks(r))


def _mark_get(fm: DeviceFMIndex, i: jax.Array) -> jax.Array:
    w = fm.mark_blocks[i // MARK_BLOCK_BITS, (i % MARK_BLOCK_BITS) // 32]
    return ((w >> (i % 32).astype(jnp.uint32)) & jnp.uint32(1)).astype(jnp.bool_)


def _mark_rank1(fm: DeviceFMIndex, i: jax.Array) -> jax.Array:
    b = i // MARK_BLOCK_BITS
    words = fm.mark_blocks[b]  # (..., 4)
    rem = i - b * MARK_BLOCK_BITS
    allowed = jnp.clip(
        rem[..., None] - 32 * jnp.arange(MARK_WORDS_PER_BLOCK, dtype=i.dtype), 0, 32
    ).astype(jnp.uint32)
    safe = jnp.clip(32 - allowed, 0, 31).astype(jnp.uint32)
    masks = jnp.where(allowed == 0, jnp.uint32(0), _FULL >> safe)
    part = jnp.sum(jax.lax.population_count(words & masks).astype(jnp.int32), axis=-1)
    return fm.mark_cp[b] + part


def locate(fm: DeviceFMIndex, rows: jax.Array) -> jax.Array:
    """Text positions of BWT rows.

    With a full SA resident in HBM this is ONE gather; otherwise a bounded
    LF walk to the nearest sparse-SA sample (fixed trip count).  Results are
    bit-identical either way (the walk reconstructs exactly SA[row])."""
    if fm.full_sa is not None:
        return fm.full_sa[rows.astype(jnp.int32)]

    def body(_, state):
        i, d = state
        marked = _mark_get(fm, i)
        nxt = lf_fused(fm, i)
        i = jnp.where(marked, i, nxt)
        d = jnp.where(marked, d, d + 1)
        return i, d

    i0 = rows.astype(jnp.int32)
    d0 = jnp.zeros_like(i0)
    i, d = jax.lax.fori_loop(0, fm.sample_rate, body, (i0, d0))
    return fm.ssa_values[_mark_rank1(fm, i)] + d
