"""Wavelet-matrix rank over the BWT (SURVEY.md §2 #6 — the reference's
`WaveletArray` alternative to the sampled occurrence table).

For the 4-letter DNA alphabet the wavelet matrix is two bit-vector levels:
level 0 stores each symbol's high bit; level 1 stores the low bit after a
stable partition by the high bit.  ``rank(c, i)`` is two bit-vector rank
queries per level.

This is the *space-lean* backend (2n bits + rank samples ~ 0.31 n bytes vs.
0.375 n for the fused occ layout) but costs 4 dependent lookups per query
instead of one fused row gather, so the HBM-fused layout (`ops.rank`)
remains the default; the wavelet backend exists for rank-structure
parity and as the better choice for larger alphabets.
"""

from __future__ import annotations

import numpy as np

from ..utils.bitvector import BitVector


class WaveletRank:
    """occ(c, i) over a 2-bit symbol sequence via a 2-level wavelet matrix."""

    def __init__(self, codes: np.ndarray):
        codes = np.asarray(codes, dtype=np.uint8)
        self.n = codes.size
        hi = (codes >> 1) & 1
        self.l0 = BitVector(hi.astype(bool))
        self.z0 = int((hi == 0).sum())  # symbols with high bit 0
        # stable partition by high bit, then low bits
        order = np.argsort(hi, kind="stable")
        lo_bits = (codes[order] & 1).astype(bool)
        self.l1 = BitVector(lo_bits)
        # zeros (low bit 0) inside each partition, for per-partition rank
        self.z1_left = int((~lo_bits[: self.z0]).sum())

    def rank(self, c: int, i) -> np.ndarray:
        """#occurrences of code c in codes[0, i); vectorised over i."""
        i = np.atleast_1d(np.asarray(i, dtype=np.int64))
        b0 = (c >> 1) & 1
        b1 = c & 1
        # step into level 1: position inside the b0 partition
        r1 = self.l0.rank1(i)
        i1 = (i - r1) if b0 == 0 else r1
        base = 0 if b0 == 0 else self.z0
        lo_rank = self.l1.rank1(base + i1) - self.l1.rank1(np.full_like(i1, base))
        if b1 == 1:
            return lo_rank
        return i1 - lo_rank

    def device_arrays(self):
        """Bit-vector words + checkpoints, ready for a device twin."""
        return {
            "l0_words": self.l0._wpad,
            "l0_cp": self.l0.checkpoints,
            "l1_words": self.l1._wpad,
            "l1_cp": self.l1.checkpoints,
            "z0": self.z0,
        }


# ---- device twin: the same two-level wavelet rank, HBM-resident ----------
#
# ``DeviceWaveletRank`` consumes ``device_arrays()`` and answers occ(c, i)
# with two sampled-popcount bit-vector ranks per level — 4 dependent block
# gathers per query vs 1 for the fused 48-byte rows in ``ops.rank``, but at
# 0.31 n bytes vs 0.375 n.  ``exact_search_wavelet`` is the backend's
# consumer: a full backward search bit-identical to the fused-row engine
# (tests/test_wavelet.py).

import dataclasses
from dataclasses import dataclass

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class DeviceWaveletRank:
    l0_words: jax.Array  # (nb0 * 4,) uint32, LSB-first
    l0_cp: jax.Array  # (nb0 + 1,) int32 rank1 checkpoints per 128 bits
    l1_words: jax.Array
    l1_cp: jax.Array
    z0: jax.Array  # () int32: count of high-bit-0 symbols
    n: int = dataclasses.field(metadata=dict(static=True))


def to_device(wv: WaveletRank) -> DeviceWaveletRank:
    a = wv.device_arrays()
    return DeviceWaveletRank(
        l0_words=jnp.asarray(a["l0_words"]),
        l0_cp=jnp.asarray(a["l0_cp"].astype(np.int32)),
        l1_words=jnp.asarray(a["l1_words"]),
        l1_cp=jnp.asarray(a["l1_cp"].astype(np.int32)),
        z0=jnp.int32(a["z0"]),
        n=wv.n,
    )


_BLOCK_BITS = 128
_WPB = 4  # uint32 words per checkpoint block


def _dev_rank1(words: jax.Array, cp: jax.Array, i: jax.Array) -> jax.Array:
    """rank1(i) on a device bit vector; vectorised over i (any shape)."""
    i = i.astype(jnp.int32)
    b = i // _BLOCK_BITS
    blk = words.reshape(-1, _WPB)[b]  # (..., 4)
    rem = i - b * _BLOCK_BITS
    allowed = jnp.clip(
        rem[..., None] - 32 * jnp.arange(_WPB, dtype=jnp.int32), 0, 32
    ).astype(jnp.uint32)
    safe = jnp.clip(32 - allowed, 0, 31).astype(jnp.uint32)
    masks = jnp.where(allowed == 0, jnp.uint32(0), jnp.uint32(0xFFFFFFFF) >> safe)
    part = jnp.sum(jax.lax.population_count(blk & masks).astype(jnp.int32), axis=-1)
    return cp[b] + part


def device_rank(wv: DeviceWaveletRank, c: jax.Array, i: jax.Array) -> jax.Array:
    """occ(c, i): #occurrences of code c in [0, i); c and i vectorised."""
    c = c.astype(jnp.int32)
    b0 = (c >> 1) & 1
    b1 = c & 1
    r1 = _dev_rank1(wv.l0_words, wv.l0_cp, i)
    i1 = jnp.where(b0 == 0, i.astype(jnp.int32) - r1, r1)
    base = jnp.where(b0 == 0, 0, wv.z0)
    lo = _dev_rank1(wv.l1_words, wv.l1_cp, base + i1) - _dev_rank1(
        wv.l1_words, wv.l1_cp, base
    )
    return jnp.where(b1 == 1, lo, i1 - lo)


def exact_search_wavelet(
    wv: DeviceWaveletRank,
    C: jax.Array,  # (5,) int32 cumulative counts
    primary: jax.Array,  # () int32 BWT primary row
    reads: jax.Array,  # (B, L) int32
    lengths: jax.Array,  # (B,)
) -> tuple[jax.Array, jax.Array]:
    """Backward search with wavelet-rank occ; bit-identical (lo, hi) to
    ``models.exact.exact_interval_search`` on the fused-row backend.

    The wavelet stores BWT *symbols only* — the primary-row $ position is
    not a symbol, so row coordinates are adjusted the same way the fused
    layout does (skip the primary row before ranking)."""
    B, L = reads.shape

    def occ(c, k):
        k_adj = k - (k > primary).astype(jnp.int32)
        return device_rank(wv, c, k_adj)

    def body(t, state):
        lo, hi = state
        j = lengths - 1 - t
        active = (j >= 0) & (lo < hi)
        c = jnp.take_along_axis(reads, jnp.clip(j, 0)[:, None], axis=1)[:, 0]
        Cc = C[c.astype(jnp.int32)]
        nlo = Cc + occ(c, lo)
        nhi = Cc + occ(c, hi)
        return jnp.where(active, nlo, lo), jnp.where(active, nhi, hi)

    lo0 = jnp.zeros(B, jnp.int32)
    hi0 = jnp.full(B, wv.n + 1, jnp.int32)
    return jax.lax.fori_loop(0, L, body, (lo0, hi0))
