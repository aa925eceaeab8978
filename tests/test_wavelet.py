"""Wavelet-matrix rank vs. naive counting and vs. the occ table."""

import numpy as np
import pytest

from genome_weaver_align.index.wavelet import WaveletRank


@pytest.mark.parametrize("n,seed", [(1, 0), (63, 1), (128, 2), (1000, 3), (5000, 4)])
def test_wavelet_rank_vs_naive(n, seed):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    w = WaveletRank(codes)
    ks = np.arange(n + 1)
    for c in range(4):
        expect = np.concatenate([[0], np.cumsum(codes == c)])
        got = w.rank(c, ks)
        assert np.array_equal(got, expect), f"c={c}"


def test_wavelet_matches_occ_table():
    from genome_weaver_align.index.build import build_fm_index
    from genome_weaver_align.utils import packing

    codes = np.random.default_rng(9).integers(0, 4, size=3000, dtype=np.uint8)
    fm = build_fm_index(codes)
    bwt = packing.unpack(fm.bwt_words, fm.n)
    w = WaveletRank(bwt)
    ks = np.random.default_rng(1).integers(0, fm.n + 1, size=200)
    for c in range(4):
        assert np.array_equal(w.rank(c, ks), fm.occ_packed(c, ks))


def test_device_wavelet_rank_matches_host():
    """HBM-resident twin (to_device/device_rank) vs the host WaveletRank,
    per-lane codes, including i=0 and i=n edges."""
    import jax.numpy as jnp

    from genome_weaver_align.index import wavelet

    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=4097, dtype=np.uint8)
    w = WaveletRank(codes)
    dw = wavelet.to_device(w)
    ks = np.concatenate([[0, codes.size], rng.integers(0, codes.size + 1, 300)])
    for c in range(4):
        want = w.rank(c, ks)
        got = np.asarray(
            wavelet.device_rank(dw, jnp.full(ks.size, c, jnp.int32), jnp.asarray(ks))
        )
        assert np.array_equal(got, want), f"c={c}"
    # mixed per-lane codes (the backward-search access pattern)
    cs = rng.integers(0, 4, size=ks.size)
    want = np.array([w.rank(int(c), int(k))[0] for c, k in zip(cs, ks)])
    got = np.asarray(wavelet.device_rank(dw, jnp.asarray(cs), jnp.asarray(ks)))
    assert np.array_equal(got, want)


def test_exact_search_wavelet_bit_identical_to_fused():
    """Full backward search on the wavelet backend == the fused-row engine
    (same (lo, hi) for hit and miss reads)."""
    import jax.numpy as jnp

    from genome_weaver_align.index import wavelet
    from genome_weaver_align.index.build import build_fm_index
    from genome_weaver_align.models import exact
    from genome_weaver_align.ops import rank
    from genome_weaver_align.utils import packing

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=5000, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=8)
    dfm = rank.from_host(fm)
    dw = wavelet.to_device(WaveletRank(packing.unpack(fm.bwt_words, fm.n)))

    B, L = 32, 24
    starts = rng.integers(0, codes.size - L, size=B)
    reads = np.stack([codes[s : s + L] for s in starts]).astype(np.int32)
    reads[::5] = rng.integers(0, 4, size=(reads[::5].shape[0], L))  # misses
    lengths = np.full(B, L, np.int32)
    lengths[::7] = L - 5

    lo0, hi0 = exact.exact_interval_search(
        dfm, jnp.asarray(reads), jnp.asarray(lengths)
    )
    lo1, hi1 = wavelet.exact_search_wavelet(
        dw,
        jnp.asarray(fm.C.astype(np.int32)),
        jnp.int32(fm.primary),
        jnp.asarray(reads),
        jnp.asarray(lengths),
    )
    assert np.array_equal(np.asarray(lo0), np.asarray(lo1))
    assert np.array_equal(np.asarray(hi0), np.asarray(hi1))
