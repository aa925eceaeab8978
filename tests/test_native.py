"""Native C++ SA-IS vs. oracles (skipped cleanly if the toolchain is absent)."""

import numpy as np
import pytest

from genome_weaver_align.index import native
from genome_weaver_align.index.sais import suffix_array_naive

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native toolchain unavailable"
)


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (17, 2), (500, 3), (4000, 4)])
def test_native_sais_vs_naive(n, seed):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    assert np.array_equal(native.suffix_array_native(codes), suffix_array_naive(codes))


def test_native_sais_repetitive():
    for codes in (
        np.zeros(513, np.uint8),
        np.tile(np.array([0, 1, 2, 3], np.uint8), 200),
        np.tile(np.array([3, 3, 1], np.uint8), 321),
        np.array([3, 2, 1, 0], np.uint8),
    ):
        assert np.array_equal(
            native.suffix_array_native(codes), suffix_array_naive(codes)
        )


def test_native_bwt_matches_build():
    from genome_weaver_align.index.build import build_fm_index
    from genome_weaver_align.utils import packing

    codes = np.random.default_rng(9).integers(0, 4, size=3000, dtype=np.uint8)
    sa = native.suffix_array_native(codes)
    bwt, primary = native.bwt_native(codes, sa.astype(np.int32))
    fm = build_fm_index(codes, sa=sa)
    assert primary == fm.primary
    assert np.array_equal(packing.unpack(fm.bwt_words, codes.size), bwt)


def test_build_uses_native_by_default():
    codes = np.random.default_rng(10).integers(0, 4, size=2000, dtype=np.uint8)
    from genome_weaver_align.index.build import build_fm_index

    fm = build_fm_index(codes)
    lo, hi = fm.backward_search(codes[100:130])
    assert hi - lo >= 1
    assert 100 in fm.locate(np.arange(lo, hi)).tolist()
