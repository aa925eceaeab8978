"""BWT-interval index sharding + collective rank merges (SURVEY.md §2 P2/P3,
§5.7/§5.8; acceptance config 5).

Human-scale indexes don't fit (or shouldn't be replicated into) one chip's
HBM.  The index is split into contiguous BWT rank-ranges: each device on the
``interval`` mesh axis owns a block-aligned slice of the packed BWT + its
occurrence checkpoints, of the sparse-SA mark bits, and of the sampled SA
values.  Every rank/LF/locate query is answered by the owning shard and
merged with ``psum`` over the interval axis (non-owners contribute zero) —
the per-extension-step collective traffic that the scaling configs exercise.

Two coordinate spaces are sharded independently (both 128-aligned):
- packed BWT coordinates [0, n]   -> bwt blocks + occ checkpoints
- BWT row coordinates   [0, n+1)  -> sparse-SA marks, sampled values

Checkpoint values stay GLOBAL (no rebasing), so a local partial popcount plus
the local checkpoint already yields the global occ value.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
import jax
import jax.numpy as jnp
import numpy as np

from ..index.build import BLOCK_BASES, WORDS_PER_BLOCK, FMIndexData
from ..ops import rank as rank_ops
from ..ops.rank import MARK_BLOCK_BITS, MARK_WORDS_PER_BLOCK

_PAIR = jnp.uint32(0x55555555)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ShardedFMIndex:
    """Stacked per-shard tables; leading axis = interval shard."""

    bwt_blocks: jax.Array  # (S, nbs+1, 8) uint32
    occ_cp: jax.Array  # (S, nbs+1, 4) int32 (global values)
    C: jax.Array  # (5,) int32 (replicated)
    primary: jax.Array  # () int32
    pk_start: jax.Array  # (S,) int32 packed-coordinate shard starts
    pk_end: jax.Array  # (S,) int32 (exclusive; last = n+1 to own k == n)
    mark_blocks: jax.Array  # (S, mbs, 4) uint32
    mark_cp: jax.Array  # (S, mbs+1) int32 (global rank1 at local block starts)
    row_start: jax.Array  # (S,) int32 row-coordinate shard starts
    row_end: jax.Array  # (S,) int32
    ssa_values: jax.Array  # (S, vmax) int32 (padded)
    ssa_base: jax.Array  # (S,) int32 marked rows before this shard
    n: int = dataclasses.field(metadata=dict(static=True))
    sample_rate: int = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))


def shard_fm_index(fm: FMIndexData, n_shards: int) -> ShardedFMIndex:
    """Host-side split of FMIndexData into n_shards stacked slices."""
    n = fm.n
    # ---- packed space
    nb_total = fm.bwt_words.size // WORDS_PER_BLOCK  # includes +1 pad block
    nbs = -(-nb_total // n_shards)
    bwt = np.zeros((n_shards, nbs + 1, WORDS_PER_BLOCK), dtype=np.uint32)
    occ = np.zeros((n_shards, nbs + 1, 4), dtype=np.int32)
    blocks = fm.bwt_words.reshape(nb_total, WORDS_PER_BLOCK)
    pk_start = np.zeros(n_shards, np.int32)
    pk_end = np.zeros(n_shards, np.int32)
    for s in range(n_shards):
        b0 = s * nbs
        b1 = min(nb_total, b0 + nbs + 1)  # +1: boundary block overlap
        if b0 < nb_total:
            bwt[s, : b1 - b0] = blocks[b0:b1]
            occ[s, : b1 - b0] = fm.occ_cp[b0:b1].astype(np.int32)
        # clamped, disjoint, and covering [0, n]: the +1-padded final block
        # guarantees (nb_total)*BLOCK_BASES > n, so k == n has an owner
        pk_start[s] = min(b0 * BLOCK_BASES, n + 1)
        pk_end[s] = min((b0 + nbs) * BLOCK_BASES, n + 1)
    # ---- row space
    marks = fm.ssa_marks
    mw = marks._wpad  # (mb_total * 4,) uint32 words over n+1 rows
    mb_total = mw.size // MARK_WORDS_PER_BLOCK
    mbs = -(-mb_total // n_shards)
    mblk = np.zeros((n_shards, mbs, MARK_WORDS_PER_BLOCK), dtype=np.uint32)
    mcp = np.zeros((n_shards, mbs + 1), dtype=np.int32)
    row_start = np.zeros(n_shards, np.int32)
    row_end = np.zeros(n_shards, np.int32)
    mwords = mw.reshape(mb_total, MARK_WORDS_PER_BLOCK)
    cps = marks.checkpoints.astype(np.int32)  # (mb_total+1,)
    ssa_base = np.zeros(n_shards, np.int32)
    ssa_parts = []
    for s in range(n_shards):
        b0 = s * mbs
        b1 = min(mb_total, b0 + mbs)
        if b0 < mb_total:
            mblk[s, : b1 - b0] = mwords[b0:b1]
            mcp[s, : b1 - b0 + 1] = cps[b0 : b1 + 1]
        row_start[s] = min(b0 * MARK_BLOCK_BITS, n + 1)
        row_end[s] = min((b0 + mbs) * MARK_BLOCK_BITS, n + 1)
        ssa_base[s] = cps[min(b0, mb_total)]
        lo_rank = int(ssa_base[s])
        hi_rank = int(cps[min(b0 + mbs, mb_total)])
        ssa_parts.append(fm.ssa_values[lo_rank:hi_rank].astype(np.int32))
    vmax = max(1, max(p.size for p in ssa_parts))
    ssa = np.zeros((n_shards, vmax), dtype=np.int32)
    for s, p in enumerate(ssa_parts):
        ssa[s, : p.size] = p

    return ShardedFMIndex(
        bwt_blocks=jnp.asarray(bwt),
        occ_cp=jnp.asarray(occ),
        C=jnp.asarray(fm.C.astype(np.int32)),
        primary=jnp.asarray(np.int32(fm.primary)),
        pk_start=jnp.asarray(pk_start),
        pk_end=jnp.asarray(pk_end),
        mark_blocks=jnp.asarray(mblk),
        mark_cp=jnp.asarray(mcp),
        row_start=jnp.asarray(row_start),
        row_end=jnp.asarray(row_end),
        ssa_values=jnp.asarray(ssa),
        ssa_base=jnp.asarray(ssa_base),
        n=int(fm.n),
        sample_rate=int(fm.sample_rate),
        n_shards=n_shards,
    )


# ---- local (per-shard) query kernels: run INSIDE shard_map, where every
# array has its leading shard axis stripped to this device's slice (size 1
# squeezed by the caller).  Non-owned queries contribute 0; psum merges.


def _local_pair_masks(r):
    return rank_ops._pair_masks(r)


def local_occ_codes(sh: ShardedFMIndex, codes, k):
    """This shard's contribution to occ$(codes, k); caller psums."""
    k_adj = (k - (k > sh.primary)).astype(jnp.int32)
    own = (k_adj >= sh.pk_start) & (k_adj < sh.pk_end)
    kk = jnp.clip(k_adj, sh.pk_start, None)
    b_local = (kk - sh.pk_start) // BLOCK_BASES
    b_local = jnp.clip(b_local, 0, sh.bwt_blocks.shape[0] - 1)
    r = kk - sh.pk_start - b_local * BLOCK_BASES
    words = sh.bwt_blocks[b_local]
    base = jnp.take_along_axis(
        sh.occ_cp[b_local], codes[..., None].astype(jnp.int32), axis=-1
    )[..., 0]
    val = base + rank_ops._match_counts(words, codes, _local_pair_masks(r))
    return jnp.where(own, val, 0)


def local_occ_all4(sh: ShardedFMIndex, k):
    k_adj = (k - (k > sh.primary)).astype(jnp.int32)
    own = (k_adj >= sh.pk_start) & (k_adj < sh.pk_end)
    kk = jnp.clip(k_adj, sh.pk_start, None)
    b_local = jnp.clip((kk - sh.pk_start) // BLOCK_BASES, 0, sh.bwt_blocks.shape[0] - 1)
    r = kk - sh.pk_start - b_local * BLOCK_BASES
    words = sh.bwt_blocks[b_local]
    masks = _local_pair_masks(r)
    counts = [
        rank_ops._match_counts(words, jnp.full(k.shape, c, jnp.int32), masks)
        for c in range(4)
    ]
    val = sh.occ_cp[b_local] + jnp.stack(counts, axis=-1)
    return jnp.where(own[..., None], val, 0)


def local_bwt_char(sh: ShardedFMIndex, i):
    """One-hot-ish char contribution: owner returns code, others 0 (sum ok)."""
    idx = (i - (i > sh.primary)).astype(jnp.int32)
    own = (idx >= sh.pk_start) & (idx < sh.pk_end) & (idx < sh.n)
    local = jnp.clip(idx - sh.pk_start, 0, None)
    b_local = jnp.clip(local // BLOCK_BASES, 0, sh.bwt_blocks.shape[0] - 1)
    w = sh.bwt_blocks[b_local, (local % BLOCK_BASES) // 16]
    c = ((w >> (2 * (local % 16)).astype(jnp.uint32)) & jnp.uint32(3)).astype(jnp.int32)
    return jnp.where(own, c, 0)


def local_mark_get(sh: ShardedFMIndex, i):
    own = (i >= sh.row_start) & (i < sh.row_end)
    local = jnp.clip(i - sh.row_start, 0, None)
    b = jnp.clip(local // MARK_BLOCK_BITS, 0, sh.mark_blocks.shape[0] - 1)
    w = sh.mark_blocks[b, (local % MARK_BLOCK_BITS) // 32]
    bit = ((w >> (local % 32).astype(jnp.uint32)) & jnp.uint32(1)).astype(jnp.int32)
    return jnp.where(own, bit, 0)


def local_mark_rank1(sh: ShardedFMIndex, i):
    """Global rank1(i) contribution (checkpoints hold global values)."""
    own = (i >= sh.row_start) & (i < sh.row_end)
    local = jnp.clip(i - sh.row_start, 0, None)
    b = jnp.clip(local // MARK_BLOCK_BITS, 0, sh.mark_blocks.shape[0] - 1)
    words = sh.mark_blocks[b]
    rem = local - b * MARK_BLOCK_BITS
    allowed = jnp.clip(
        rem[..., None] - 32 * jnp.arange(MARK_WORDS_PER_BLOCK, dtype=i.dtype), 0, 32
    ).astype(jnp.uint32)
    safe = jnp.clip(32 - allowed, 0, 31).astype(jnp.uint32)
    masks = jnp.where(allowed == 0, jnp.uint32(0), jnp.uint32(0xFFFFFFFF) >> safe)
    part = jnp.sum(jax.lax.population_count(words & masks).astype(jnp.int32), axis=-1)
    return jnp.where(own, sh.mark_cp[b] + part, 0)


def local_ssa_value(sh: ShardedFMIndex, i, global_rank):
    own = (i >= sh.row_start) & (i < sh.row_end)
    slot = jnp.clip(global_rank - sh.ssa_base, 0, sh.ssa_values.shape[0] - 1)
    return jnp.where(own, sh.ssa_values[slot], 0)


# ---- merged (collective) primitives — call INSIDE shard_map over axis name.


def occ_codes(sh, codes, k, axis: str):
    return jax.lax.psum(local_occ_codes(sh, codes, k), axis)


def backward_step(sh, codes, lo, hi, axis: str):
    part = jnp.stack(
        [local_occ_codes(sh, codes, lo), local_occ_codes(sh, codes, hi)]
    )
    occ_lo, occ_hi = jax.lax.psum(part, axis)
    Cc = sh.C[codes.astype(jnp.int32)]
    return Cc + occ_lo, Cc + occ_hi


def lf(sh, i, axis: str):
    c = jax.lax.psum(local_bwt_char(sh, i), axis)
    return sh.C[c] + jax.lax.psum(local_occ_codes(sh, c, i), axis)


def locate(sh, rows, axis: str):
    """Bounded LF walk with a psum per step (the config-5 hot collective)."""

    def body(_, state):
        i, d = state
        marked = jax.lax.psum(local_mark_get(sh, i), axis) > 0
        nxt = lf(sh, i, axis)
        return jnp.where(marked, i, nxt), jnp.where(marked, d, d + 1)

    i0 = rows.astype(jnp.int32)
    i, d = jax.lax.fori_loop(0, sh.sample_rate, body, (i0, jnp.zeros_like(i0)))
    grank = jax.lax.psum(local_mark_rank1(sh, i), axis)
    val = jax.lax.psum(local_ssa_value(sh, i, grank), axis)
    return val + d


# ---- shard_map plumbing -----------------------------------------------------

_STACKED = (
    "bwt_blocks",
    "occ_cp",
    "pk_start",
    "pk_end",
    "mark_blocks",
    "mark_cp",
    "row_start",
    "row_end",
    "ssa_values",
    "ssa_base",
)


def index_specs(axis: str, like: ShardedFMIndex):
    """PartitionSpec pytree for a ShardedFMIndex under shard_map.

    Static metadata (n, sample_rate, n_shards) must match ``like`` because
    it is part of the pytree structure shard_map compares against."""
    from jax.sharding import PartitionSpec as P

    kw = {f: P(axis) for f in _STACKED}
    kw.update(C=P(), primary=P())
    return dataclasses.replace(like, **kw)


def squeeze_local(sh: ShardedFMIndex) -> ShardedFMIndex:
    """Strip the size-1 shard axis of this device's slice (inside shard_map)."""
    kw = {f: getattr(sh, f)[0] for f in _STACKED}
    return dataclasses.replace(sh, **kw)


def put_sharded(sh: ShardedFMIndex, mesh, axis: str) -> ShardedFMIndex:
    """Place stacked shards on the mesh: shard axis -> mesh axis."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    kw = {
        f: jax.device_put(getattr(sh, f), NamedSharding(mesh, P(axis)))
        for f in _STACKED
    }
    rep = NamedSharding(mesh, P())
    kw.update(
        C=jax.device_put(sh.C, rep), primary=jax.device_put(sh.primary, rep)
    )
    return dataclasses.replace(sh, **kw)


def make_sharded_exact_search(
    mesh,
    interval_axis: str,
    data_axis: str,
    max_len: int,
    like: ShardedFMIndex = None,
    *,
    microbatch: int = 1,
):
    """Build a jitted shard_map exact search over (data, interval) axes.

    Reads are data-sharded and replicated across interval; the index is
    interval-sharded.  Returns fn(sharded_index, reads, lengths) ->
    (lo, hi, positions) with positions from the sharded locate.  Every
    extension step merges the interval shards' occ partials with one
    ``psum``, which XLA lowers to an all-reduce (NCCL on GPUs).

    ``microbatch`` > 1 splits the local read batch into that many interleaved
    chunks per extension step: chunk m+1's local rank gathers carry no data
    dependency on chunk m's merge, so the scheduler can overlap one chunk's
    all-reduce with another chunk's gathers.
    """
    from jax.sharding import PartitionSpec as P

    def local_fn(sh, reads, lengths):
        sh = squeeze_local(sh)
        B, L = reads.shape
        mb = microbatch if B % microbatch == 0 else 1
        Bc = B // mb

        def chunk(a, m):
            return a[m * Bc : (m + 1) * Bc]

        def body(t, chunks):
            out = []
            for m in range(mb):
                lo, hi = chunks[m]
                j = chunk(lengths, m) - 1 - t
                active = (j >= 0) & (lo < hi)
                c = jnp.take_along_axis(
                    chunk(reads, m), jnp.clip(j, 0)[:, None], axis=1
                )[:, 0]
                nlo, nhi = backward_step(sh, c, lo, hi, interval_axis)
                out.append((jnp.where(active, nlo, lo), jnp.where(active, nhi, hi)))
            return tuple(out)

        chunks0 = tuple(
            (jnp.zeros(Bc, jnp.int32), jnp.full(Bc, sh.n + 1, jnp.int32))
            for _ in range(mb)
        )
        chunks = jax.lax.fori_loop(0, max_len, body, chunks0)
        lo = jnp.concatenate([s[0] for s in chunks])
        hi = jnp.concatenate([s[1] for s in chunks])
        pos = locate(sh, jnp.clip(lo, 0, sh.n), interval_axis)
        pos = jnp.where(hi > lo, pos, -1)
        return lo, hi, pos

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(index_specs(interval_axis, like), P(data_axis), P(data_axis)),
        out_specs=(P(data_axis), P(data_axis), P(data_axis)),
        check_vma=False,
    )
    return jax.jit(fn)
