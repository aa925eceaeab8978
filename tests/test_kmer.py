"""k-mer prefix table: table-seeded search must equal plain backward search."""

import numpy as np
import pytest
import jax.numpy as jnp

from genome_weaver_align.index.build import build_fm_index
from genome_weaver_align.index.kmer import build_kmer_table, kmer_index_of
from genome_weaver_align.models import exact
from genome_weaver_align.ops import rank


@pytest.fixture(scope="module")
def setup():
    codes = np.random.default_rng(41).integers(0, 4, size=12000, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=16)
    return codes, fm, rank.from_host(fm)


@pytest.mark.parametrize("j", [1, 2, 4, 6])
def test_table_entries_vs_backward_search(setup, j):
    codes, fm, dfm = setup
    lo, hi = build_kmer_table(fm, j)
    rng = np.random.default_rng(j)
    for _ in range(40):
        pat = rng.integers(0, 4, size=j)
        idx = 0
        for c in pat:
            idx = (idx << 2) | int(c)
        want = fm.backward_search(pat.astype(np.uint8))
        got = (int(lo[idx]), int(hi[idx]))
        if want[1] <= want[0]:
            assert got[1] <= got[0]
        else:
            assert got == want


@pytest.mark.parametrize("j", [4, 8])
def test_seeded_search_matches_plain(setup, j):
    codes, fm, dfm = setup
    lo_t, hi_t = build_kmer_table(fm, j)
    tab = (jnp.asarray(lo_t), jnp.asarray(hi_t))
    rng = np.random.default_rng(7 + j)
    B, L = 64, 30
    reads = np.zeros((B, L), dtype=np.int32)
    lengths = rng.integers(j - 2 if j > 2 else 1, L + 1, size=B).astype(np.int32)
    for i in range(B):
        l = int(lengths[i])
        if rng.random() < 0.7:
            p = int(rng.integers(0, codes.size - l))
            reads[i, :l] = codes[p : p + l]
        else:
            reads[i, :l] = rng.integers(0, 4, size=l)
    plain = exact.exact_interval_search(dfm, jnp.asarray(reads), jnp.asarray(lengths))
    seeded = exact.exact_interval_search(
        dfm, jnp.asarray(reads), jnp.asarray(lengths), kmer_tab=tab, kmer_j=j
    )
    for a, b in zip(plain, seeded):
        a, b = np.asarray(a), np.asarray(b)
        # dead intervals may differ in representation; widths and live
        # intervals must agree exactly
        live = np.asarray(plain[1]) > np.asarray(plain[0])
        assert np.array_equal(
            np.maximum(np.asarray(plain[1]) - np.asarray(plain[0]), 0) > 0,
            np.maximum(np.asarray(seeded[1]) - np.asarray(seeded[0]), 0) > 0,
        )
        assert np.array_equal(a[live], b[live])
