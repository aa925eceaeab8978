"""Banded edit-distance DP verify (SURVEY.md §2 #11/#12/P5).

The reference verifies candidate loci with Myers' bit-parallel edit distance
(`BitParallelSmithWaterman.align64`) and produces CIGARs with a banded
Smith-Waterman traceback.  Here the verify is a *wavefront* over the band:
the DP state is one band-row tensor (Q, BAND) advanced one read position per
step, all candidate lanes in lockstep; the O(BAND) in-row deletion
dependency is an unrolled running-min scan (BAND is small: 4k+1).

Coordinate convention (shared with ``models.suffix_filter``):
- candidate locus estimate ``cand`` -> window starts at ``ws = cand - k``,
  window width ``W >= L + 3k`` (true start may drift +-k; <=k indels drift
  the diagonal +-k further).
- band slot b in [0, 4k] represents window position j = i + b - k at read
  position i.

Semi-global: leading/trailing window characters are free (D(0, j) = 0,
answer = min_b D(L, b)); the read must align end-to-end.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

INF = jnp.int32(1 << 20)


@partial(jax.jit, static_argnames=("k", "max_len"))
def banded_edit_distance(
    reads: jax.Array,  # (Q, L) int32 codes; values >= 4 never match
    lengths: jax.Array,  # (Q,)
    windows: jax.Array,  # (Q, W) int32 codes; values >= 4 never match
    k: int,
    max_len: int | None = None,
):
    """Min edit distance of each read vs. any substring of its window.

    Returns (dist (Q,), end_b (Q,)) where end_b is the argmin band slot
    (window end position = lengths + end_b - k), for traceback seeding.
    """
    Q, L = reads.shape
    W = windows.shape[1]
    band = 4 * k + 1
    steps = L if max_len is None else max_len

    boff = jnp.arange(band, dtype=jnp.int32) - k  # j - i per slot

    def body(i, D):
        active = (i < lengths)[:, None]
        j = i + boff[None, :]  # (1->Q, band)
        valid = (j >= 0) & (j < W)
        wchar = jnp.take_along_axis(windows, jnp.clip(j, 0, W - 1), axis=1)
        sub = jnp.where(
            valid & (wchar == reads[:, i][:, None]) & (reads[:, i][:, None] < 4),
            0,
            1,
        )
        diag = D + sub
        # read-insertion: D(i, j) -> D(i+1, j): slot shifts down by one
        ins = jnp.concatenate([D[:, 1:], jnp.full((Q, 1), INF)], axis=1) + 1
        tmp = jnp.minimum(diag, ins)
        tmp = jnp.where(valid, tmp, INF)
        # window-deletion: running min along the band (in-row dependency)
        cols = [tmp[:, 0]]
        for b in range(1, band):
            cols.append(jnp.minimum(tmp[:, b], cols[-1] + 1))
        Dn = jnp.stack(cols, axis=1)
        return jnp.where(active, Dn, D)

    # row i=0: D(0, j) = 0 wherever j = b - k is a valid window position
    D0 = jnp.where((boff >= 0)[None, :], 0, INF) + jnp.zeros((Q, 1), jnp.int32)
    D = jax.lax.fori_loop(0, steps, body, D0)

    j_end = lengths[:, None] + boff[None, :]
    valid_end = (j_end >= 0) & (j_end <= W)
    Df = jnp.where(valid_end, D, INF)
    # clamp unreachable lanes to exactly INF (garbage accumulates +1s above
    # it); keeps the engines (jnp / Pallas) bit-identical on dead lanes
    dist = jnp.minimum(jnp.min(Df, axis=1), INF)
    end_b = jnp.argmin(Df, axis=1).astype(jnp.int32)
    return dist, end_b


def verify_engine(platform: str) -> str:
    """The banded-verify engine for devices of ``platform``.

    "gpu" runs the Triton-route Pallas kernel (``ops.dp_pallas``), "cpu" the
    jnp wavefront above; both give the same ``dist`` on every lane.  Any
    other platform has no engine and raises."""
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "jnp"
    raise ValueError(f"no banded-verify engine for platform {platform!r}")


def banded_edit_distance_best(
    reads: jax.Array, lengths: jax.Array, windows: jax.Array, k: int,
    *, platform: str | None = None,
):
    """Banded verify on the engine of the target devices' ``platform``.

    ``platform`` defaults to the default backend's, which is what a plain
    ``jax.jit`` targets.  Code compiled for an explicit device set (a mesh)
    passes that set's platform."""
    if verify_engine(platform or jax.default_backend()) == "pallas":
        from . import dp_pallas

        return dp_pallas.banded_edit_distance_pallas(reads, lengths, windows, k)
    return banded_edit_distance(reads, lengths, windows, k)


@partial(jax.jit, static_argnames=("max_len",))
def hamming_distance(
    reads: jax.Array, lengths: jax.Array, windows: jax.Array, offset: int | jax.Array, max_len: int | None = None
):
    """Substitution-only verify: mismatches of read vs window[offset:offset+len]."""
    Q, L = reads.shape
    W = windows.shape[1]
    idx = jnp.arange(L, dtype=jnp.int32)[None, :] + jnp.asarray(offset, jnp.int32).reshape(-1, 1)
    valid = (idx >= 0) & (idx < W)
    wchar = jnp.take_along_axis(windows, jnp.clip(idx, 0, W - 1), axis=1)
    in_read = jnp.arange(L, dtype=jnp.int32)[None, :] < lengths[:, None]
    mm = (wchar != reads) | (reads >= 4) | ~valid
    return jnp.sum(jnp.where(in_read, mm, False).astype(jnp.int32), axis=1)


# ------------------------------------------------- batched band traceback
#
# The per-read "slow path" (indel CIGARs) used to run the full-matrix host
# DP at ~5 ms/read; for indel-heavy streams that dominates the whole batch.
# This pair computes the same banded DP as ``banded_edit_distance`` (numpy,
# vectorised over reads) while keeping every band row, then walks all
# tracebacks in lockstep — O(L) tiny numpy steps for the entire cohort.

_HINF = np.int32(1 << 20)


def banded_rows_host(reads: np.ndarray, lengths: np.ndarray, windows: np.ndarray, k: int):
    """Band DP keeping all rows: (Q, L+1, band) int32, device-identical."""
    Q, L = reads.shape
    W = windows.shape[1]
    band = 4 * k + 1
    boff = np.arange(band, dtype=np.int64) - k
    D = np.empty((Q, L + 1, band), dtype=np.int32)
    D[:, 0, :] = np.where(boff >= 0, 0, _HINF)[None, :]
    reads = np.asarray(reads, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.int64)
    for i in range(L):
        prev = D[:, i, :]
        j = i + boff[None, :]  # (1, band) diag-predecessor window positions
        valid = (j >= 0) & (j < W)
        wchar = np.take_along_axis(windows, np.clip(j, 0, W - 1), axis=1)
        sub = np.where(
            valid & (wchar == reads[:, i][:, None]) & (reads[:, i][:, None] < 4), 0, 1
        )
        diag = prev + sub
        ins = np.concatenate([prev[:, 1:], np.full((Q, 1), _HINF, np.int32)], axis=1) + 1
        tmp = np.minimum(diag, ins)
        tmp = np.where(valid, tmp, _HINF)
        run = tmp[:, 0].copy()
        out = D[:, i + 1, :]
        out[:, 0] = run
        for b in range(1, band):
            run = np.minimum(tmp[:, b], run + 1)
            out[:, b] = run
        active = i < lengths
        out[~active] = prev[~active]
    return D


def traceback_banded_batch(
    reads: np.ndarray,  # (Q, L) verify codes (>=4 never matches)
    lengths: np.ndarray,  # (Q,)
    windows: np.ndarray,  # (Q, W)
    k: int,
):
    """Banded DP + lockstep traceback for a read cohort.

    Returns (dist (Q,), start_in_window (Q,), cigars list[str]).  Operation
    preference is M > I > D at equal cost (same order as the full-matrix
    ``traceback_semiglobal_host``); ties at the end pick the smallest window
    end position (first argmin), matching ``banded_edit_distance``'s end_b.
    """
    Q, L = reads.shape
    W = windows.shape[1]
    band = 4 * k + 1
    boff = np.arange(band, dtype=np.int64) - k
    D = banded_rows_host(reads, lengths, windows, k)
    lengths = np.asarray(lengths, dtype=np.int64)
    reads = np.asarray(reads, dtype=np.int64)

    j_end = lengths[:, None] + boff[None, :]
    Df = np.where((j_end >= 0) & (j_end <= W), D[np.arange(Q), lengths, :], _HINF)
    dist = Df.min(axis=1).astype(np.int64)
    b = Df.argmin(axis=1).astype(np.int64)

    i = lengths.copy()
    max_steps = L + 2 * k + 1
    ops = np.zeros((Q, max_steps), dtype=np.int8)  # 0 none, 1 M, 2 I, 3 D
    q = np.arange(Q)
    for step in range(max_steps):
        active = i > 0
        if not active.any():
            break
        j = i + b - k  # current cell's window position
        cur = D[q, i, b]
        ip = np.maximum(i - 1, 0)
        jp = j - 1  # diag predecessor window position (char indices i-1, j-1)
        wchar = np.take_along_axis(windows, np.clip(jp, 0, W - 1)[:, None], axis=1)[:, 0]
        rchar = np.take_along_axis(reads, np.clip(ip, 0, L - 1)[:, None], axis=1)[:, 0]
        sub = np.where((jp >= 0) & (jp < W) & (wchar == rchar) & (rchar < 4), 0, 1)
        diag_ok = active & (j >= 1) & (cur == D[q, ip, b] + sub)
        bp = np.minimum(b + 1, band - 1)
        ins_ok = active & ~diag_ok & (b + 1 < band) & (cur == D[q, ip, bp] + 1)
        bm = np.maximum(b - 1, 0)
        del_ok = active & ~diag_ok & ~ins_ok & (b >= 1) & (cur == D[q, i, bm] + 1)
        assert bool(np.all(diag_ok | ins_ok | del_ok | ~active)), "traceback stuck"
        ops[:, step] = np.where(diag_ok, 1, np.where(ins_ok, 2, np.where(del_ok, 3, 0)))
        i = i - (diag_ok | ins_ok)
        b = np.where(ins_ok, b + 1, np.where(del_ok, b - 1, b))
    start = (i + b - k).astype(np.int64)  # i == 0 here: window start of alignment

    cigars = []
    sym = "?MID"
    for qi in range(Q):
        row = ops[qi][ops[qi] != 0][::-1]  # reverse: traceback ran end -> start
        if row.size == 0:
            cigars.append("")
            continue
        cut = np.nonzero(np.diff(row))[0]
        runs = np.diff(np.r_[-1, cut, row.size - 1])
        vals = row[np.r_[cut, row.size - 1]]
        cigars.append("".join(f"{r}{sym[v]}" for r, v in zip(runs, vals)))
    return dist, start, cigars


# ---------------------------------------------------------------- host oracle

def edit_distance_semiglobal_host(read: np.ndarray, window: np.ndarray) -> int:
    """Full-matrix oracle: min edits of read vs any substring of window."""
    L, W = read.size, window.size
    prev = np.zeros(W + 1, dtype=np.int64)
    for i in range(L):
        cur = np.empty(W + 1, dtype=np.int64)
        cur[0] = i + 1
        sub = prev[:-1] + ((window != read[i]) | (read[i] >= 4))
        ins = prev[1:] + 1
        best = np.minimum(sub, ins)
        # sequential deletion scan
        run = cur[0]
        for j in range(W):
            run = min(best[j], run + 1)
            cur[j + 1] = run
        prev = cur
    return int(prev.min())


def traceback_semiglobal_host(read: np.ndarray, window: np.ndarray):
    """Full DP + traceback -> (dist, start_in_window, end_in_window, cigar).

    CIGAR uses M (match/mismatch), I (insertion to reference = extra read
    base), D (deletion from reference).  Leading/trailing window bases free.
    """
    L, W = read.size, window.size
    D = np.zeros((L + 1, W + 1), dtype=np.int64)
    D[:, 0] = np.arange(L + 1)
    for i in range(1, L + 1):
        sub = D[i - 1, :-1] + ((window != read[i - 1]) | (read[i - 1] >= 4))
        ins = D[i - 1, 1:] + 1
        best = np.minimum(sub, ins)
        run = D[i, 0]
        for j in range(W):
            run = min(best[j], run + 1)
            D[i, j + 1] = run
    dist = int(D[L].min())
    j = int(D[L].argmin())
    i = L
    ops = []
    while i > 0:
        if j > 0 and D[i, j] == D[i - 1, j - 1] + ((window[j - 1] != read[i - 1]) | (read[i - 1] >= 4)):
            ops.append("M")
            i -= 1
            j -= 1
        elif D[i, j] == D[i - 1, j] + 1:
            ops.append("I")
            i -= 1
        elif j > 0 and D[i, j] == D[i, j - 1] + 1:
            ops.append("D")
            j -= 1
        else:  # pragma: no cover - defensive
            raise AssertionError("traceback stuck")
    start = j
    ops.reverse()
    # run-length encode
    cigar = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1][0] += 1
        else:
            cigar.append([1, op])
    cigar_str = "".join(f"{c}{op}" for c, op in cigar)
    return dist, start, int(D[L].argmin()), cigar_str
