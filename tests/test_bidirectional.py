"""Bidirectional BWT search vs. naive occurrence counting — the synchronized
interval pair must track (pattern, reversed pattern) in (fwd, rev) indexes."""

import numpy as np
import pytest
import jax.numpy as jnp

from genome_weaver_align.index.build import build_fm_index
from genome_weaver_align.models import bidirectional as bd


def naive_count(text, pat):
    n, m = text.size, pat.size
    if m == 0:
        return n + 1  # every position incl. sentinel row convention
    return sum(1 for i in range(n - m + 1) if np.array_equal(text[i : i + m], pat))


@pytest.fixture(scope="module")
def setup():
    codes = np.random.default_rng(7).integers(0, 4, size=800, dtype=np.uint8)
    fwd = build_fm_index(codes, sample_rate=8)
    rev = build_fm_index(codes[::-1].copy(), sample_rate=8)
    return codes, fwd, rev


@pytest.mark.parametrize("seed", range(6))
def test_host_bidir_extensions(setup, seed):
    codes, fwd, rev = setup
    rng = np.random.default_rng(seed)
    bi = bd.HostBiIndex(fwd, rev)
    # grow a pattern from a planted window, extending randomly on both sides
    L = 16
    p0 = int(rng.integers(0, codes.size - L))
    left = right = p0 + L // 2  # current pattern = codes[left:right]
    st = bi.init()
    for _ in range(L):
        if rng.random() < 0.5 and left > p0:
            left -= 1
            st = bi.extend_backward(st, int(codes[left]))
        elif right < p0 + L:
            right += 1
            st = bi.extend_forward(st, int(codes[right - 1]))
        else:
            left -= 1
            st = bi.extend_backward(st, int(codes[left]))
        pat = codes[left:right]
        lo, hi, rlo, rhi = st
        assert hi - lo == naive_count(codes, pat), f"pat={pat}"
        assert rhi - rlo == hi - lo
        assert rhi - rlo == naive_count(codes[::-1], pat[::-1])
        # intervals must be real: locate fwd interval and check occurrences
        if hi > lo:
            pos = sorted(int(x) for x in fwd.locate(np.arange(lo, hi)))
            want = sorted(
                i
                for i in range(codes.size - pat.size + 1)
                if np.array_equal(codes[i : i + pat.size], pat)
            )
            assert pos == want
            rpos = sorted(int(x) for x in rev.locate(np.arange(rlo, rhi)))
            rwant = sorted(
                i
                for i in range(codes.size - pat.size + 1)
                if np.array_equal(codes[::-1][i : i + pat.size], pat[::-1])
            )
            assert rpos == rwant


def test_device_matches_host(setup):
    codes, fwd, rev = setup
    bi_h = bd.HostBiIndex(fwd, rev)
    bi_d = bd.from_host_bi(fwd, rev)
    rng = np.random.default_rng(3)
    # batch of random walks, one step at a time, host vs device
    B = 32
    sts_h = [bi_h.init() for _ in range(B)]
    st_d = bd.init_interval(fwd.n, (B,))
    for step in range(12):
        cs = rng.integers(0, 4, size=B)
        dirs = rng.integers(0, 2, size=B)
        # host
        for i in range(B):
            f = bi_h.extend_backward if dirs[i] else bi_h.extend_forward
            sts_h[i] = f(sts_h[i], int(cs[i]))
        # device: apply both and select (masking pattern used in search kernels)
        c = jnp.asarray(cs, jnp.int32)
        bwd = bd.extend_backward(bi_d, st_d, c)
        fwd_ = bd.extend_forward(bi_d, st_d, c)
        sel = jnp.asarray(dirs, bool)
        st_d = bd.BiInterval(*[jnp.where(sel, b, f) for b, f in zip(bwd, fwd_)])
        got = np.stack([np.asarray(x) for x in st_d], axis=1)
        want = np.array(sts_h)
        assert np.array_equal(got, want), f"step {step}"


def test_extend_all4_consistent(setup):
    codes, fwd, rev = setup
    bi_d = bd.from_host_bi(fwd, rev)
    st = bd.init_interval(fwd.n, (8,))
    rng = np.random.default_rng(5)
    for _ in range(6):
        c = jnp.asarray(rng.integers(0, 4, size=8), jnp.int32)
        all4b = bd.extend_backward_all4(bi_d, st)
        one = bd.extend_backward(bi_d, st, c)
        for f_all, f_one in zip(all4b, one):
            got = np.take_along_axis(np.asarray(f_all), np.asarray(c)[:, None], axis=1)[:, 0]
            assert np.array_equal(got, np.asarray(f_one))
        all4f = bd.extend_forward_all4(bi_d, st)
        onef = bd.extend_forward(bi_d, st, c)
        for f_all, f_one in zip(all4f, onef):
            got = np.take_along_axis(np.asarray(f_all), np.asarray(c)[:, None], axis=1)[:, 0]
            assert np.array_equal(got, np.asarray(onef[0] if f_one is onef[0] else f_one))
        st = one
