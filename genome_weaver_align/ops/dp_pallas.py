"""Banded edit-distance verify as a Pallas kernel on the Triton route (P5).

One program owns a power-of-two block of candidate lanes and runs the whole
read-length wavefront over it with the DP state in registers: the band is
``4k + 1`` separate (block,) vectors, so no band padding and no shuffles.

Layout: the wrapper transposes reads to (L, Q) and windows to (L + 4k, Q)
int8, pad-shifted by ``k`` (``padT[r] = windows[:, r - k]``, code 4 outside
the window), so step ``i`` of the wavefront reads one contiguous row of
reads and one new window row (the other ``band - 1`` rows of the sliding
window ride in the loop carry).  Both rows are coalesced block-wide loads
of int8.  The transposes and pads are XLA ops ahead of the kernel.

Matches ``ops.dp.banded_edit_distance`` bit for bit in ``dist`` and
``end_b`` on every lane, dead lanes (clamped to exactly INF) included:
the arithmetic is the same int32 min-plus recurrence in the same order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

INF = 1 << 20  # saturation value, matches ops.dp.INF
BLOCK = 128  # candidate lanes per program (power of two), one per thread


def _kernel(reads_ref, len_ref, win_ref, dist_ref, endb_ref, *, L, W, k):
    band = 4 * k + 1
    lengths = len_ref[...]
    inf = jnp.int32(INF)
    D0 = tuple(
        jnp.full(lengths.shape, 0 if b >= k else INF, jnp.int32) for b in range(band)
    )
    # window rows i-1 .. i+band-2 enter step i; slot 0 is rotated out first
    w0 = (jnp.zeros(lengths.shape, jnp.int8),) + tuple(
        win_ref[b, :] for b in range(band - 1)
    )

    def step(i, carry):
        D, w = carry
        w = w[1:] + (win_ref[i + band - 1, :],)
        r = reads_ref[i, :]
        rok = r < 4
        active = i < lengths
        out = []
        run = None
        for b in range(band):
            j = i + (b - k)  # window position of this band slot
            sub = jnp.where((w[b] == r) & rok, 0, 1)
            ins = D[b + 1] + 1 if b + 1 < band else inf + 1
            tmp = jnp.minimum(D[b] + sub, ins)
            tmp = jnp.where((j >= 0) & (j < W), tmp, inf)
            # window-deletion: serial running min along the band
            run = tmp if b == 0 else jnp.minimum(tmp, run + 1)
            out.append(jnp.where(active, run, D[b]))
        return tuple(out), w

    D, _ = jax.lax.fori_loop(0, L, step, (D0, w0))

    # first argmin over the end slots whose window end is in range
    best = end = None
    for b in range(band):
        j_end = lengths + (b - k)
        df = jnp.where((j_end >= 0) & (j_end <= W), D[b], inf)
        if b == 0:
            best, end = df, jnp.zeros_like(lengths)
        else:
            better = df < best
            best = jnp.where(better, df, best)
            end = jnp.where(better, b, end)
    dist_ref[...] = jnp.minimum(best, inf)
    endb_ref[...] = end


@partial(jax.jit, static_argnames=("k", "interpret", "block"))
def banded_edit_distance_pallas(
    reads: jax.Array,  # (Q, L) int8 codes in [0, 127]; >= 4 never match
    lengths: jax.Array,  # (Q,)
    windows: jax.Array,  # (Q, W) int8 codes; >= 4 never match
    k: int,
    interpret: bool = False,
    block: int = BLOCK,
):
    """Drop-in for ``ops.dp.banded_edit_distance``: (dist (Q,), end_b (Q,))."""
    Q, L = reads.shape
    W = windows.shape[1]
    if L >= INF:  # distances must stay below the saturation value
        raise ValueError(f"read length {L} >= {INF}: kernel would saturate")
    if block & (block - 1):
        raise ValueError(f"block {block} is not a power of two")
    band = 4 * k + 1
    H = L + band - 1  # last step reads window row L - 1 + 4k
    Qp = -(-Q // block) * block
    readsT = jnp.pad(reads.astype(jnp.int8), ((0, Qp - Q), (0, 0))).T
    take = min(W, H - k)
    padT = jnp.pad(
        windows.astype(jnp.int8)[:, :take],
        ((0, Qp - Q), (k, H - k - take)),
        constant_values=4,
    ).T
    lenp = jnp.pad(lengths.astype(jnp.int32), (0, Qp - Q))
    dist, endb = pl.pallas_call(
        partial(_kernel, L=L, W=W, k=k),
        grid=(Qp // block,),
        in_specs=[
            pl.BlockSpec((L, block), lambda q: (0, q)),
            pl.BlockSpec((block,), lambda q: (q,)),
            pl.BlockSpec((H, block), lambda q: (0, q)),
        ],
        out_specs=[
            pl.BlockSpec((block,), lambda q: (q,)),
            pl.BlockSpec((block,), lambda q: (q,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((Qp,), jnp.int32),
            jax.ShapeDtypeStruct((Qp,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=max(1, block // 32), num_stages=1),
        interpret=interpret,
        name="banded_verify",
    )(readsT, lenp, padT)
    return dist[:Q], endb[:Q]
