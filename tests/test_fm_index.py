"""Oracle tests: SA construction, FM-index occ/backward-search/locate
(SURVEY.md §4 pattern: fast structure vs. naive reimplementation)."""

import numpy as np
import pytest

from genome_weaver_align.index.build import build_fm_index
from genome_weaver_align.index.sais import suffix_array, suffix_array_naive
from genome_weaver_align.utils import dna


def rand_codes(n, seed=0):
    return np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (10, 2), (100, 3), (1000, 4)])
def test_suffix_array_vs_naive(n, seed):
    codes = rand_codes(n, seed)
    assert np.array_equal(suffix_array(codes), suffix_array_naive(codes))


def test_suffix_array_repetitive():
    # worst case for doubling: highly periodic text
    codes = np.tile(dna.encode("ACGT"), 64)
    assert np.array_equal(suffix_array(codes), suffix_array_naive(codes))
    codes = np.zeros(257, dtype=np.uint8)  # all-A run
    assert np.array_equal(suffix_array(codes), suffix_array_naive(codes))


@pytest.mark.parametrize("n,seed", [(64, 0), (300, 1), (1000, 2)])
def test_occ_vs_naive(n, seed):
    codes = rand_codes(n, seed)
    fm = build_fm_index(codes)
    sa = suffix_array(codes)
    # reconstruct sentinel-inclusive BWT naively
    bwt = np.where(sa > 0, codes[np.maximum(sa - 1, 0)], -1)  # -1 = $
    ks = np.arange(n + 2)
    for c in range(4):
        expect = np.concatenate([[0], np.cumsum(bwt == c)])
        assert np.array_equal(fm.occ(c, ks), expect), f"c={c}"


def naive_find(codes, pat):
    n, m = codes.size, pat.size
    return sorted(
        i for i in range(n - m + 1) if np.array_equal(codes[i : i + m], pat)
    )


@pytest.mark.parametrize("seed", range(4))
def test_backward_search_vs_naive(seed):
    rng = np.random.default_rng(seed)
    codes = rand_codes(500, seed + 10)
    fm = build_fm_index(codes)
    for m in (1, 3, 8, 20):
        for _ in range(10):
            if rng.random() < 0.7:  # planted pattern
                p = int(rng.integers(0, codes.size - m))
                pat = codes[p : p + m].copy()
            else:  # random pattern (may be absent)
                pat = rng.integers(0, 4, size=m, dtype=np.uint8)
            lo, hi = fm.backward_search(pat)
            expect = naive_find(codes, pat)
            assert hi - lo == len(expect)
            if expect:
                got = sorted(int(x) for x in fm.locate(np.arange(lo, hi)))
                assert got == expect


@pytest.mark.parametrize("sample_rate", [1, 4, 32, 64])
def test_locate_all_rows(sample_rate):
    codes = rand_codes(400, 5)
    fm = build_fm_index(codes, sample_rate=sample_rate)
    sa = suffix_array(codes)
    rows = np.arange(codes.size + 1)
    assert np.array_equal(fm.locate(rows), sa)


def test_extract():
    codes = rand_codes(300, 6)
    fm = build_fm_index(codes)
    assert np.array_equal(fm.extract(37, 50), codes[37:87])
    assert np.array_equal(fm.extract(290, 50), codes[290:])
