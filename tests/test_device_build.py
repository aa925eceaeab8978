"""Device (jax-sort prefix doubling) SA builder vs. oracles."""

import numpy as np
import pytest

from genome_weaver_align.index.device_build import suffix_array_device
from genome_weaver_align.index.sais import suffix_array_naive


@pytest.mark.parametrize("n,seed", [(1, 0), (2, 1), (63, 2), (1000, 3), (5000, 4)])
def test_device_sa_vs_naive(n, seed):
    codes = np.random.default_rng(seed).integers(0, 4, size=n, dtype=np.uint8)
    assert np.array_equal(suffix_array_device(codes), suffix_array_naive(codes))


def test_device_sa_repetitive():
    for codes in (
        np.zeros(300, np.uint8),
        np.tile(np.array([0, 1, 2, 3], np.uint8), 128),
        np.tile(np.array([1, 1, 0], np.uint8), 200),
    ):
        assert np.array_equal(suffix_array_device(codes), suffix_array_naive(codes))


def test_device_sa_feeds_index_build():
    from genome_weaver_align.index.build import build_fm_index

    codes = np.random.default_rng(9).integers(0, 4, size=3000, dtype=np.uint8)
    fm = build_fm_index(codes, sa=suffix_array_device(codes))
    lo, hi = fm.backward_search(codes[500:540])
    assert hi - lo >= 1
    assert 500 in fm.locate(np.arange(lo, hi)).tolist()
