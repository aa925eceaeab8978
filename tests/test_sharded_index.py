"""Interval-sharded index over a (data x interval) CPU mesh must be
bit-identical to the single-device index (SURVEY.md §4 multi-device plan)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from genome_weaver_align.index.build import build_fm_index
from genome_weaver_align.models import exact
from genome_weaver_align.ops import rank
from genome_weaver_align.parallel import mesh as pmesh
from genome_weaver_align.parallel import sharded_index as si


@pytest.fixture(scope="module")
def setup():
    codes = np.random.default_rng(31).integers(0, 4, size=5000, dtype=np.uint8)
    fm = build_fm_index(codes, sample_rate=16)
    return codes, fm


@pytest.mark.parametrize("microbatch", [1, 2])
@pytest.mark.parametrize(
    "n_data,n_interval", [(1, 2), (2, 2), (1, 4), (4, 2), (2, 4), (1, 8)]
)
def test_sharded_exact_search_matches_single(setup, n_data, n_interval, microbatch):
    """psum-merged search over every mesh shape, with and without the
    interleaved microbatch chunks, equals the single-device search."""
    codes, fm = setup
    m = pmesh.make_mesh(n_data=n_data, n_interval=n_interval)
    sh = si.shard_fm_index(fm, n_interval)
    sh = si.put_sharded(sh, m, pmesh.INTERVAL_AXIS)

    rng = np.random.default_rng(1)
    B, L = 16 * n_data, 28
    reads = np.zeros((B, L), dtype=np.int32)
    lengths = np.full(B, L, np.int32)
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        reads[i] = codes[p : p + L]

    fn = si.make_sharded_exact_search(
        m, pmesh.INTERVAL_AXIS, pmesh.DATA_AXIS, max_len=L, like=sh,
        microbatch=microbatch,
    )
    r, l, _ = pmesh.shard_reads(m, reads, lengths)
    lo, hi, pos = fn(sh, r, l)
    lo, hi, pos = np.asarray(lo), np.asarray(hi), np.asarray(pos)

    dfm = rank.from_host(fm)
    slo, shi = exact.exact_interval_search(dfm, jnp.asarray(reads), jnp.asarray(lengths))
    assert np.array_equal(lo, np.asarray(slo))
    assert np.array_equal(hi, np.asarray(shi))
    spos = np.asarray(rank.locate(dfm, jnp.clip(slo, 0, fm.n)))
    spos = np.where(np.asarray(shi) > np.asarray(slo), spos, -1)
    assert np.array_equal(pos, spos)


def test_sharded_occ_all_positions(setup):
    """Every occ value over the whole coordinate range, via psum merge."""
    codes, fm = setup
    n_interval = 4
    m = pmesh.make_mesh(n_data=2, n_interval=n_interval)
    sh = si.shard_fm_index(fm, n_interval)
    sh = si.put_sharded(sh, m, pmesh.INTERVAL_AXIS)
    from jax.sharding import PartitionSpec as P

    ks = np.arange(fm.n + 2, dtype=np.int32)
    pad = (-ks.size) % 2
    ks = np.concatenate([ks, np.zeros(pad, np.int32)])

    def f(shl, k):
        shl = si.squeeze_local(shl)
        return jax.lax.psum(
            si.local_occ_codes(shl, jnp.zeros_like(k), k), pmesh.INTERVAL_AXIS
        )

    fn = jax.jit(
        jax.shard_map(
            f,
            mesh=m,
            in_specs=(si.index_specs(pmesh.INTERVAL_AXIS, sh), P(pmesh.DATA_AXIS)),
            out_specs=P(pmesh.DATA_AXIS),
            check_vma=False,
        )
    )
    got = np.asarray(fn(sh, jnp.asarray(ks)))[: fm.n + 2]
    want = fm.occ(0, np.arange(fm.n + 2))
    assert np.array_equal(got, want)
