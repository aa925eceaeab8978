"""Banded-verify Pallas kernel (Triton route) vs the jnp reference.

On the CPU the kernel runs in interpret mode; the tests marked ``gpu`` run
it compiled on the card, through the engine dispatch the pipeline uses.
"""

import numpy as np
import pytest
import jax.numpy as jnp

import chip_smoke
from genome_weaver_align.ops import dp, dp_pallas


def _both(reads, lengths, wins, k, **kw):
    args = (jnp.asarray(reads), jnp.asarray(lengths), jnp.asarray(wins))
    want = dp.banded_edit_distance(*args, k)
    got = dp_pallas.banded_edit_distance_pallas(*args, k, interpret=True, **kw)
    return [np.asarray(a) for a in (*got, *want)]


@pytest.mark.parametrize("L", [30, 50, 100, 150])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_kernel_matches_jnp(k, L):
    # Q = 200 is not a multiple of the 128-lane block: the last block is padded
    lanes = chip_smoke.check_engine(n=200, L=L, k=k, seed=10 * k + L, interpret=True)
    assert lanes > 0  # planted lanes exercise the within-k distances


def test_kernel_planted_matches_host_oracle(k=2):
    rng = np.random.default_rng(5)
    genome = rng.integers(0, 4, size=3000).astype(np.int8)
    Q, L = 96, 60
    W = L + 3 * k
    reads = np.zeros((Q, L), np.int8)
    wins = np.zeros((Q, W), np.int8)
    expect = np.zeros(Q, np.int64)
    for q in range(Q):
        p = int(rng.integers(k, genome.size - W - k))
        r = genome[p : p + L].copy()
        for _ in range(int(rng.integers(0, k + 1))):
            at = int(rng.integers(0, L))
            r[at] = (r[at] + 1 + rng.integers(0, 3)) % 4
        reads[q] = r
        wins[q] = genome[p - k : p - k + W]
        expect[q] = dp.edit_distance_semiglobal_host(r, wins[q])
    got, _, _, _ = _both(reads, np.full(Q, L, np.int32), wins, k)
    sel = expect <= k
    assert sel.all()
    assert np.array_equal(got[sel], expect[sel])


def test_kernel_dead_lanes_clamp_to_inf():
    # windows narrower than the read: no band slot reaches a valid end, so
    # both engines clamp the lane to exactly INF
    rng = np.random.default_rng(3)
    Q, L, k, W = 40, 50, 2, 20
    reads = rng.integers(0, 4, size=(Q, L)).astype(np.int8)
    wins = rng.integers(0, 4, size=(Q, W)).astype(np.int8)
    got, got_b, want, want_b = _both(reads, np.full(Q, L, np.int32), wins, k)
    assert (want == int(dp.INF)).all()
    assert np.array_equal(got, want) and np.array_equal(got_b, want_b)


@pytest.mark.parametrize("block", [32, 256])
def test_kernel_block_sizes(block):
    rng = np.random.default_rng(block)
    Q, L, k = 300, 40, 2
    reads = rng.integers(0, 5, size=(Q, L)).astype(np.int8)
    wins = rng.integers(0, 5, size=(Q, L + 3 * k)).astype(np.int8)
    lengths = rng.integers(0, L + 1, size=Q).astype(np.int32)
    got, got_b, want, want_b = _both(reads, lengths, wins, k, block=block)
    assert np.array_equal(got, want) and np.array_equal(got_b, want_b)


def test_kernel_rejects_saturating_length():
    # guard trips at trace time, before any buffers are materialised
    Q, L, k = 1, 1 << 20, 2
    with pytest.raises(ValueError, match="saturate"):
        dp_pallas.banded_edit_distance_pallas(
            jnp.zeros((Q, L), jnp.int8),
            jnp.full((Q,), L, jnp.int32),
            jnp.zeros((Q, L + 3 * k), jnp.int8),
            k,
            interpret=True,
        )


def test_kernel_rejects_non_power_of_two_block():
    with pytest.raises(ValueError, match="power of two"):
        dp_pallas.banded_edit_distance_pallas(
            jnp.zeros((4, 8), jnp.int8), jnp.full((4,), 8, jnp.int32),
            jnp.zeros((4, 14), jnp.int8), 2, interpret=True, block=96,
        )


@pytest.mark.parametrize(
    "platform,engine", [("gpu", "pallas"), ("cpu", "jnp")]
)
def test_verify_engine_dispatch(platform, engine):
    assert dp.verify_engine(platform) == engine


@pytest.mark.parametrize("platform", ["rocm", "metal", ""])
def test_verify_engine_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="no banded-verify engine"):
        dp.verify_engine(platform)


def test_best_runs_jnp_on_cpu():
    rng = np.random.default_rng(1)
    reads = jnp.asarray(rng.integers(0, 4, size=(16, 30)), jnp.int8)
    wins = jnp.asarray(rng.integers(0, 4, size=(16, 36)), jnp.int8)
    lengths = jnp.full((16,), 30, jnp.int32)
    got = dp.banded_edit_distance_best(reads, lengths, wins, 2)
    want = dp.banded_edit_distance(reads, lengths, wins, 2)
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        dp.banded_edit_distance_best(reads, lengths, wins, 2, platform="rocm")


@pytest.mark.gpu
@pytest.mark.parametrize("case", chip_smoke.GPU_CASES, ids=lambda c: f"L{c['L']}k{c['k']}")
def test_engine_on_gpu(gpu, case):
    """The compiled kernel on the card, bit-identical to jnp under XLA."""
    assert dp.verify_engine(gpu.platform) == "pallas"
    chip_smoke.check_engine(**case)
