"""Device rank/search/locate vs. NumPy oracle — must be bit-identical."""

import numpy as np
import pytest
import jax.numpy as jnp

from genome_weaver_align.index.build import build_fm_index
from genome_weaver_align.models import exact
from genome_weaver_align.ops import rank


@pytest.fixture(scope="module")
def fm_pair():
    codes = np.random.default_rng(42).integers(0, 4, size=2000, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=16)
    return codes, fm, rank.from_host(fm)


def test_occ_codes_vs_oracle(fm_pair):
    codes, fm, dfm = fm_pair
    rng = np.random.default_rng(0)
    k = rng.integers(0, fm.n + 2, size=256)
    for c in range(4):
        host = fm.occ(c, k)
        dev = rank.occ_codes(dfm, jnp.full(k.shape, c, jnp.int32), jnp.asarray(k, jnp.int32))
        assert np.array_equal(np.asarray(dev), host), f"c={c}"


def test_occ_all4_vs_oracle(fm_pair):
    codes, fm, dfm = fm_pair
    k = np.random.default_rng(1).integers(0, fm.n + 2, size=128)
    dev = np.asarray(rank.occ_all4(dfm, jnp.asarray(k, jnp.int32)))
    host = np.stack([fm.occ(c, k) for c in range(4)], axis=-1)
    assert np.array_equal(dev, host)


def test_lf_and_locate_vs_oracle(fm_pair):
    codes, fm, dfm = fm_pair
    rows = np.arange(fm.n + 1)
    not_primary = rows != fm.primary
    dev_lf = np.asarray(rank.lf(dfm, jnp.asarray(rows, jnp.int32)))
    host_lf = fm.lf(rows)
    assert np.array_equal(dev_lf[not_primary], host_lf[not_primary])
    dev_pos = np.asarray(rank.locate(dfm, jnp.asarray(rows, jnp.int32)))
    assert np.array_equal(dev_pos, fm.locate(rows))


def test_exact_search_vs_oracle(fm_pair):
    codes, fm, dfm = fm_pair
    rng = np.random.default_rng(2)
    B, L = 64, 24
    reads = np.zeros((B, L), dtype=np.int32)
    lengths = rng.integers(8, L + 1, size=B).astype(np.int32)
    for i in range(B):
        l = lengths[i]
        if rng.random() < 0.8:
            p = rng.integers(0, codes.size - l)
            reads[i, :l] = codes[p : p + l]
        else:
            reads[i, :l] = rng.integers(0, 4, size=l)
    lo, hi = exact.exact_interval_search(dfm, jnp.asarray(reads), jnp.asarray(lengths))
    lo, hi = np.asarray(lo), np.asarray(hi)
    for i in range(B):
        hlo, hhi = fm.backward_search(reads[i, : lengths[i]])
        assert (max(0, hi[i] - lo[i])) == hhi - hlo
        if hhi > hlo:
            assert (lo[i], hi[i]) == (hlo, hhi)
    pos, valid = exact.locate_hits(dfm, jnp.asarray(lo), jnp.asarray(hi), max_hits=8)
    pos, valid = np.asarray(pos), np.asarray(valid)
    for i in range(B):
        if hi[i] > lo[i]:
            want = fm.locate(np.arange(lo[i], min(hi[i], lo[i] + 8)))
            got = pos[i][valid[i]]
            assert np.array_equal(np.sort(got), np.sort(want))
