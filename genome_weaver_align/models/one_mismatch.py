"""1-mismatch bidirectional BWT search (acceptance config 2; SURVEY.md §3.3).

Search scheme (the k=1 optimum scheme, cf. Kucherov et al. / reference's
bidirectional `SuffixFilter` at k=1): split each read P = P1 P2 at mid.

  Case A: P1 exact (built backward), then forward extension through P2
          allowing <= 1 substitution (spine keeps 0 mm; each step spawns
          3 single-mismatch branches that must finish exactly).
  Case B: P2 exact (built backward from the end), then backward extension
          through P1 requiring exactly 1 substitution (branches only).

The two cases are disjoint (error side) and complete for Hamming distance 1.

Batched shape (SURVEY.md §2 P4): the reference's per-read priority queue becomes
a dense (B, S) slot tensor of synchronized bidirectional intervals advanced
in lockstep; all lanes stay position-synchronized because every state
consumes exactly one read character per step.  Dead slots are compacted each
step with a stable argsort mask-pack; slot overflow is *flagged* per read
(never silently dropped) so the caller can fall back to the host oracle.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import bidirectional as bd
from .bidirectional import BiInterval, DeviceBiIndex


class MMState(NamedTuple):
    spine: BiInterval  # (B,)
    br: BiInterval  # (B, S) single-mismatch branches
    overflow: jax.Array  # (B,) bool


def _compact(br: BiInterval) -> tuple[BiInterval, jax.Array]:
    """Pack live slots (width>0) to the front; returns (state, live_count)."""
    alive = br.hi > br.lo
    order = jnp.argsort(jnp.logical_not(alive).astype(jnp.int32), axis=1, stable=True)
    packed = BiInterval(*[jnp.take_along_axis(f, order, axis=1) for f in br])
    return packed, jnp.sum(alive.astype(jnp.int32), axis=1)


def _spawn(br: BiInterval, count, all4: BiInterval, c, overflow):
    """Write the 3 wrong-char extensions of the spine into free slots."""
    S = br.lo.shape[1]
    slots = jnp.arange(S, dtype=jnp.int32)[None, :]
    n_live_spawn = jnp.zeros_like(count)
    fields = list(br)
    for t in range(3):
        wc = (t + (t >= c).astype(jnp.int32))[:, None]  # t-th code != c
        vals = [jnp.take_along_axis(f, wc, axis=1)[:, 0] for f in all4]
        w = vals[1] - vals[0]
        live = w > 0
        slot = count + n_live_spawn
        overflow = overflow | (live & (slot >= S))
        mask = (slots == slot[:, None]) & live[:, None]
        fields = [jnp.where(mask, v[:, None], f) for f, v in zip(fields, vals)]
        n_live_spawn = n_live_spawn + live.astype(jnp.int32)
    return BiInterval(*fields), overflow


@partial(jax.jit, static_argnames=("max_len", "n_slots"))
def one_mismatch_candidates(
    bi: DeviceBiIndex,
    reads: jax.Array,  # (B, L) int32
    lengths: jax.Array,  # (B,)
    max_len: int | None = None,
    n_slots: int = 48,
):
    """Candidate fwd-index SA intervals for all <=1-substitution matches.

    Returns (cand_lo, cand_hi) of shape (B, 2*n_slots + 1) — case-A spine
    (exact match) in slot 0, then case-A branches, then case-B branches —
    plus an overflow flag (B,).  Empty candidates have hi <= lo.
    """
    B, L = reads.shape
    steps = L if max_len is None else max_len
    mid = lengths // 2
    n = bi.fwd.n

    def char_at(j):
        return jnp.take_along_axis(reads, jnp.clip(j, 0)[:, None], axis=1)[:, 0]

    def masked(active, new: BiInterval, old: BiInterval) -> BiInterval:
        return BiInterval(*[jnp.where(active, a, b) for a, b in zip(new, old)])

    def build_backward(first, last_excl):
        """Spine = read[first(b) : last_excl(b)] built by backward extension."""

        def body(t, st):
            j = last_excl - 1 - t
            active = j >= first
            ext = bd.extend_backward(bi, st, char_at(j))
            return masked(active, ext, st)

        return jax.lax.fori_loop(0, steps, body, bd.init_interval(n, (B,)))

    empty_br = BiInterval(
        *[jnp.zeros((B, n_slots), jnp.int32) for _ in range(4)]
    )

    # ---- Case A: P1 exact, forward through P2 with <=1 mismatch
    spineA0 = build_backward(jnp.zeros_like(mid), mid)

    def bodyA(t, state: MMState):
        j = mid + t
        active = j < lengths
        c = char_at(j)
        ext = bd.extend_forward(bi, state.br, c[:, None])
        br, count = _compact(masked(active[:, None], ext, state.br))
        all4 = bd.extend_forward_all4(bi, state.spine)
        spine_new = BiInterval(
            *[jnp.take_along_axis(f, c[:, None].astype(jnp.int32), axis=1)[:, 0] for f in all4]
        )
        # freeze spawns/spine updates on inactive lanes
        br2, ovf = _spawn(br, count, all4, c, state.overflow)
        br = masked(active[:, None], br2, br)
        ovf = jnp.where(active, ovf, state.overflow)
        spine = masked(active, spine_new, state.spine)
        return MMState(spine, br, ovf)

    stA = jax.lax.fori_loop(
        0, steps, bodyA, MMState(spineA0, empty_br, jnp.zeros(B, bool))
    )

    # ---- Case B: P2 exact (backward build), backward through P1, exactly 1 mm
    spineB0 = build_backward(mid, lengths)

    def bodyB(t, state: MMState):
        j = mid - 1 - t
        active = j >= 0
        c = char_at(j)
        ext = bd.extend_backward(bi, state.br, c[:, None])
        br, count = _compact(masked(active[:, None], ext, state.br))
        all4 = bd.extend_backward_all4(bi, state.spine)
        spine_new = BiInterval(
            *[jnp.take_along_axis(f, c[:, None].astype(jnp.int32), axis=1)[:, 0] for f in all4]
        )
        br2, ovf = _spawn(br, count, all4, c, state.overflow)
        br = masked(active[:, None], br2, br)
        ovf = jnp.where(active, ovf, state.overflow)
        spine = masked(active, spine_new, state.spine)
        return MMState(spine, br, ovf)

    stB = jax.lax.fori_loop(
        0, steps, bodyB, MMState(spineB0, empty_br, jnp.zeros(B, bool))
    )

    cand_lo = jnp.concatenate(
        [stA.spine.lo[:, None], stA.br.lo, stB.br.lo], axis=1
    )
    cand_hi = jnp.concatenate(
        [stA.spine.hi[:, None], stA.br.hi, stB.br.hi], axis=1
    )
    return cand_lo, cand_hi, stA.overflow | stB.overflow


class OneMismatchAligner:
    """Acceptance config 2 as a first-class aligner: bidirectional k=1
    search scheme -> candidate intervals -> locate -> SAM.  FM-space
    branches guarantee <=1 substitution, so no DP verify is needed; the
    mismatch count for NM is a direct text comparison at the located position."""

    def __init__(self, gi, max_hits: int = 8):
        import jax.numpy as jnp

        from . import bidirectional as bd
        from ..ops import rank

        self.gi = gi
        self.bi = bd.from_host_bi(gi.fwd, gi.rev)
        self.fm = rank.from_host(gi.fwd)
        self.text_words = jnp.asarray(gi.fwd.text_words)
        self.max_hits = max_hits

    def _strand(self, search, lengths):
        import jax.numpy as jnp

        from . import exact as exact_mod

        cand_lo, cand_hi, ovf = one_mismatch_candidates(
            self.bi, jnp.asarray(search), jnp.asarray(lengths)
        )
        B, C = cand_lo.shape
        pos, valid = exact_mod.locate_hits(
            self.fm, cand_lo.reshape(-1), cand_hi.reshape(-1), 2
        )
        pos = jnp.where(valid, pos, jnp.int32(2**30)).reshape(B, C * 2)
        best = jnp.min(pos, axis=1)  # deterministic: smallest locus
        import numpy as np

        return np.asarray(best), np.asarray(ovf)

    def align_batch(self, reads):
        import numpy as np

        from .pipeline import ApproxHit, reads_to_batch_verify, revcomp_verify_batch

        lengths = np.array([len(r) for r in reads], dtype=np.int32)
        vf = reads_to_batch_verify(reads)
        sfwd = np.where(vf >= 4, 0, vf).astype(np.int32)
        vrc = revcomp_verify_batch(vf, lengths)
        src = np.where(vrc >= 4, 0, vrc).astype(np.int32)

        bf, of = self._strand(sfwd, lengths)
        br, orr = self._strand(src, lengths)
        take_r = br < bf
        pos = np.where(take_r, br, bf).astype(np.int64)
        strand = take_r.astype(np.int64)
        mapped = pos < 2**30

        vsel = np.where(strand[:, None] == 0, vf, vrc)
        out = []
        for i in range(len(reads)):
            if not mapped[i]:
                out.append(None)
                continue
            l = int(lengths[i])
            codes = vsel[i, :l]
            win = self.gi.fwd.extract(int(pos[i]), l).astype(np.int64)
            mm = int((codes[: win.size] != win).sum() + (l - win.size))
            out.append(
                ApproxHit(int(pos[i]), int(strand[i]), mm, f"{l}M", 1, bool(of[i] or orr[i]))
            )
        return out

    def to_sam(self, reads, hits):
        from .pipeline import SuffixFilterAligner

        return SuffixFilterAligner.to_sam(self, reads, hits)

    def sam_header(self):
        from ..utils import sam as sam_mod

        return sam_mod.header(self.gi.genome.names, self.gi.genome.lengths)
