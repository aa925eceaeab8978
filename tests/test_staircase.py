"""Staircase suffix filter: complete for <=k substitutions (recall vs brute
force), and strictly fewer-or-equal candidates than pigeonhole."""

import numpy as np
import pytest
import jax.numpy as jnp

from genome_weaver_align.index.build import build_fm_index
from genome_weaver_align.models import bidirectional as bd
from genome_weaver_align.models import staircase, suffix_filter
from genome_weaver_align.models.pipeline import SuffixFilterAligner
from genome_weaver_align.models.suffix_filter import NO_CAND


@pytest.fixture(scope="module")
def setup():
    codes = np.random.default_rng(23).integers(0, 4, size=40000, dtype=np.uint8)
    fwd = build_fm_index(codes, sample_rate=16)
    rev = build_fm_index(codes[::-1].copy(), sample_rate=16)
    return codes, fwd, rev, bd.from_host_bi(fwd, rev)


def brute_loci(codes, read, k):
    wins = np.lib.stride_tricks.sliding_window_view(codes, read.size)
    mm = (wins != read[None, :]).sum(axis=1)
    return set(np.nonzero(mm <= k)[0].tolist())


@pytest.mark.parametrize("k", [1, 2, 3])
def test_staircase_recall(setup, k):
    codes, fwd, rev, bi = setup
    rng = np.random.default_rng(100 + k)
    B, L = 24, 60
    reads = np.zeros((B, L), dtype=np.int32)
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        r = codes[p : p + L].astype(np.int32).copy()
        for _ in range(int(rng.integers(0, k + 1))):
            at = int(rng.integers(0, L))
            r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        reads[i] = r
    lengths = np.full(B, L, np.int32)
    res = staircase.staircase_filter_candidates(
        bi, jnp.asarray(reads), jnp.asarray(lengths), k
    )
    cand = np.asarray(res.cand_pos)
    ovf = np.asarray(res.overflow)
    for i in range(B):
        want = brute_loci(codes, reads[i], k)
        got = set(int(x) for x in cand[i] if x != NO_CAND)
        if not ovf[i]:
            assert want <= got, f"read {i}: missing {want - got}"


def test_staircase_prunes_vs_pigeonhole(setup):
    codes, fwd, rev, bi = setup
    rng = np.random.default_rng(55)
    from genome_weaver_align.ops import rank

    dfm = rank.from_host(fwd)
    k = 2
    B, L = 16, 60
    reads = np.zeros((B, L), dtype=np.int32)
    for i in range(B):
        p = int(rng.integers(0, codes.size - L))
        reads[i] = codes[p : p + L]
    lengths = np.full(B, L, np.int32)
    st = staircase.staircase_filter_candidates(
        bi, jnp.asarray(reads), jnp.asarray(lengths), k
    )
    ph = suffix_filter.pigeonhole_candidates(
        dfm, jnp.asarray(reads), jnp.asarray(lengths), k + 1, 16
    )
    # staircase candidates must be a subset of pigeonhole's (same piece split)
    for i in range(B):
        sset = set(int(x) for x in np.asarray(st.cand_pos)[i] if x != NO_CAND)
        pset = set(int(x) for x in np.asarray(ph.cand_pos)[i] if x != NO_CAND)
        assert sset <= pset
        assert sset, "planted exact read must produce at least one candidate"

def test_aligner_staircase_mode(setup):
    codes, fwd, rev, bi = setup
    from genome_weaver_align.index.files import Genome, GenomeIndex
    from genome_weaver_align.utils import simulate

    genome = Genome(
        names=["chrS"],
        offsets=np.array([0, codes.size], dtype=np.int64),
        codes=codes,
        n_mask_spans=np.zeros((0, 2), np.int64),
    )
    gi = GenomeIndex(genome, fwd, rev)
    sims = simulate.simulate_reads(codes, 30, 100, seed=2, sub_rate=0.02, max_subs=2)
    al = SuffixFilterAligner(gi, k=2, use_staircase=True)
    hits = al.align_batch([s.read for s in sims])
    for s, h in zip(sims, hits):
        assert h is not None, s.read.name
        assert h.dist <= s.n_sub
        if h.n_good == 1:
            assert h.pos == s.true_pos and h.strand == s.true_strand
