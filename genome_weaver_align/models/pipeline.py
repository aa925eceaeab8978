"""Alignment pipeline (SURVEY.md §2 #13, §3.2/§3.3 call stacks).

Per read-batch: forward + reverse-complement search -> candidate SA intervals
-> genome coordinates (sparse-SA locate on device) -> deterministic best-hit
selection -> SAM records.  Tie-breaking among equal-score candidates is
(genome position, strand) lexicographic so output is identical for any mesh
shape (SURVEY.md §7 "bit-identical SAM").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from ..index.files import GenomeIndex
from ..ops import dp as dp_ops
from ..ops import rank
from ..ops.rank import DeviceFMIndex
from ..utils import dna, sam
from ..utils.fasta import Read
from ..utils.simulate import reads_to_batch
from . import exact, suffix_filter


@dataclass
class ExactHit:
    pos: int  # global genome coordinate (multi-hit reads: the occurrence at
    #           the smallest SA rank — deterministic; mapq 0 flags ambiguity)
    strand: int  # 0 fwd, 1 rev (read maps as revcomp)
    n_hits: int  # multiplicity across both strands


class ExactAligner:
    """Acceptance config 1: exact-match backward search end-to-end.

    One jitted call per batch: both strands searched, best (smallest
    position, fwd-preferred) located, single packed download.  Accepts a
    k-mer prefix table like the flagship aligner."""

    def __init__(self, gi: GenomeIndex, max_hits: int = 16, kmer_table=None, kmer_j: int = 0):
        import jax.numpy as jnp

        self.gi = gi
        self.fm = rank.from_host(gi.fwd)
        self.max_hits = max_hits
        self.kmer_tab = None
        self.kmer_j = 0
        if kmer_table is not None and kmer_j > 0:
            self.kmer_tab = (jnp.asarray(kmer_table[0]), jnp.asarray(kmer_table[1]))
            self.kmer_j = kmer_j
        self._jit_cache = {}

    def _step(self, L):
        import jax
        from functools import partial

        key = L
        if key not in self._jit_cache:
            kmer_j = self.kmer_j

            def impl(fm, kmer_tab, reads, lengths):
                import jax.numpy as jnp

                rc = jnp.where(reads < 4, 3 - reads, reads)[:, ::-1]
                outs = []
                for batch in (reads, rc):
                    lo, hi = exact.exact_interval_search(
                        fm, batch.astype(jnp.int32), lengths,
                        kmer_tab=kmer_tab, kmer_j=kmer_j,
                    )
                    pos, valid = exact.locate_hits(fm, lo, hi, 1)
                    first = jnp.where(valid[:, 0], pos[:, 0], jnp.int32(2**30))
                    outs.append((first, jnp.maximum(hi - lo, 0)))
                (pf, wf), (pr, wr) = outs
                take_r = pr < pf
                return jnp.stack(
                    [
                        jnp.where(take_r, pr, pf),
                        take_r.astype(jnp.int32),
                        wf + wr,
                    ]
                )

            self._jit_cache[key] = jax.jit(impl)
        return self._jit_cache[key]

    def align_batch(self, reads: list[Read]):
        import jax.numpy as jnp

        lengths = np.array([len(r) for r in reads], dtype=np.int32)
        fwd = reads_to_batch(reads).astype(np.int8)
        packed = np.asarray(
            self._step(fwd.shape[1])(
                self.fm, self.kmer_tab, jnp.asarray(fwd), jnp.asarray(lengths)
            )
        )
        pos, strand, total = packed
        out: list[ExactHit | None] = []
        for p, st, t in zip(pos.tolist(), strand.tolist(), total.tolist()):
            out.append(None if p >= 2**30 else ExactHit(p, st, t))
        return out

    def to_sam(self, reads: list[Read], hits) -> list[sam.SamRecord]:
        recs = []
        for r, h in zip(reads, hits):
            if h is None:
                recs.append(sam.unmapped(r.name, r.codes, r.qual))
                continue
            ci, local = self.gi.genome.coord(h.pos)
            recs.append(
                sam.mapped(
                    r.name,
                    r.codes,
                    self.gi.genome.names[int(ci[0])],
                    int(local[0]),
                    h.strand,
                    f"{len(r)}M",
                    edit_distance=0,
                    mapq=37 if h.n_hits == 1 else 0,
                    qual=r.qual,
                )
            )
        return recs

    def sam_header(self) -> str:
        return sam.header(self.gi.genome.names, self.gi.genome.lengths)


@dataclass
class ApproxHit:
    pos: int  # global genome start of the alignment (exact, post-traceback)
    strand: int
    dist: int
    cigar: str
    n_good: int  # candidates within threshold across both strands
    overflow: bool
    score: int | None = None  # native AS from the scored affine aligner
    nm: int | None = None  # NM of the *emitted* (score-optimal) alignment


class ArrayHits(NamedTuple):
    """Column-oriented batch result (array-native API).

    ``cigars`` holds only the non-trivial (indel) CIGARs keyed by read index;
    every other mapped read's CIGAR is ``f"{length}M"``.
    """

    mapped: np.ndarray  # (B,) bool
    pos: np.ndarray  # (B,) int64, 0 where unmapped
    strand: np.ndarray  # (B,) int64
    dist: np.ndarray  # (B,) int64 (>k where unmapped)
    n_good: np.ndarray  # (B,) int64
    overflow: np.ndarray  # (B,) bool
    lengths: np.ndarray  # (B,) int32
    cigars: dict[int, str]
    aux: dict[int, tuple[int, int]]  # read idx -> (AS, NM) from the scored
    # affine traceback (slow-path reads only; fast-path AS is exact from the
    # all-M alignment).  Required (no default): a {} default on a NamedTuple
    # field is class-level shared state and in-place mutation would leak
    # entries across batches.


def prefetch_result(handle) -> None:
    """Start the device->host copy of a submitted batch's packed result
    EARLY (non-blocking).  Called by pipelined drivers right after
    submitting batch N+1: the D2H transfer then starts the moment the
    device finishes batch N instead of waiting for the host to reach
    ``align_arrays_finish`` — one less serialized round trip per
    batch."""
    if handle and handle[0] == "uniform":
        try:
            handle[3].copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass


def hits_from_arrays(ah: ArrayHits) -> list[ApproxHit | None]:
    """ArrayHits -> per-read ApproxHit list (SAM-writer compatibility)."""
    cigar_cache = {int(l): f"{l}M" for l in np.unique(ah.lengths)}
    out: list[ApproxHit | None] = []
    cols = zip(
        ah.mapped.tolist(),
        ah.pos.tolist(),
        ah.strand.tolist(),
        ah.dist.tolist(),
        ah.n_good.tolist(),
        ah.overflow.tolist(),
        ah.lengths.tolist(),
    )
    for i, (m, p, st, d, g, o, l) in enumerate(cols):
        if not m:
            out.append(None)
        else:
            score, nm = ah.aux.get(i, (None, None))
            out.append(
                ApproxHit(p, st, d, ah.cigars.get(i, cigar_cache[l]), g, o, score, nm)
            )
    return out


class SuffixFilterAligner:
    """Acceptance configs 3-4: k-edit suffix-filter search + banded DP verify
    + SAM emission (the flagship pipeline; SURVEY.md §3.3)."""

    def __init__(
        self,
        gi: GenomeIndex,
        k: int = 2,
        max_hits_per_piece: int = 8,
        use_staircase: bool = False,
        kmer_table=None,  # (lo, hi) numpy arrays from index.kmer, optional
        kmer_j: int = 0,
        verify_mode: str = "banded",  # banded | myers
        seed_table=None,  # (offsets, positions) from index.seedtable, optional
        seed_j: int = 0,
        max_cands: int | None = None,  # verify lanes per read after dedup;
        # default 8 (FM path) / 4*(k+1) (seed path, which proposes a superset)
        verify_slack: int = 6,  # batch-pooled verify budget (lanes/read avg);
        # 0 = per-read lanes (verify_candidates); >0 = compacted verify
        overflow_fallback: bool = True,  # rerun budget-overflowed reads with
        # FB_MULT-x hit/candidate budgets and per-read verify lanes (VERDICT r1
        # missing-#7: accuracy must not silently decay under slot pressure)
        scored: bool = True,  # emit indel CIGARs/POS/NM/AS from the scored
        # affine-gap aligner (ops.affine) instead of the unit-cost edit
        # traceback; selection stays edit-based (VERDICT r1 missing-#3)
        seed_probes: int = suffix_filter.SEED_PROBES,  # rare-seed probes per
        # piece (1 = piece-end-anchored only); rarest-of-R dodges repeat
        # floods, R=1 is cheapest on repeat-free genomes
        staircase_slots: int = 16,  # staircase pool lanes per (piece, read);
        # 16 fits the measured live fraction on chr20-scale repeat cohorts
        # (mean 0.5% of 64); very-high-copy families (Gbp multipart rescue)
        # branch wider — pass 64 there, the rescue cohort is tiny
        staircase_narrow_left: bool = False,  # staircase states also
        # narrow LEFT through pre-anchor pieces (whole-read intervals) —
        # completeness for high-copy repeat families at ~+2L/3 steps; see
        # staircase.staircase_filter_candidates(narrow_left=...)
        device_tables: dict | None = None,  # pre-uploaded tables (flat
        # multi-part layout, index.multipart_io.load_part_flat): keys
        # "fm" (DeviceFMIndex), "text" (packed text words on device),
        # optional "rev" (DeviceFMIndex, staircase).  When given, gi.fwd /
        # gi.rev may be None — the aligner never touches host FM data.
    ):
        import jax.numpy as jnp

        self.gi = gi
        self.k = k
        self.n_pieces = k + 1
        self.max_hits = max_hits_per_piece
        if device_tables is not None:
            self.fm = device_tables["fm"]
            self.text_words = device_tables["text"]
            # host packed text for the slow-path window decode (a device
            # gather from the finish path would queue behind the next
            # pipelined batch); optional — None falls back to the device
            self.text_host = device_tables.get("text_host")
        else:
            self.fm = rank.from_host(gi.fwd)
            self.text_words = jnp.asarray(gi.fwd.text_words)
            self.text_host = gi.fwd.text_words
        self.use_staircase = use_staircase
        self.verify_mode = verify_mode
        self.kmer_tab = None
        self.kmer_j = 0
        if kmer_table is not None and kmer_j > 0:
            self.kmer_tab = (jnp.asarray(kmer_table[0]), jnp.asarray(kmer_table[1]))
            self.kmer_j = kmer_j
        self.seed_tab = None
        self.seed_j = 0
        if seed_table is not None and seed_j > 0:
            self.seed_tab = (jnp.asarray(seed_table[0]), jnp.asarray(seed_table[1]))
            self.seed_j = seed_j
        if max_cands is None:
            max_cands = 4 * (k + 1) if self.seed_tab is not None else 8
        self.max_cands = max_cands
        self.verify_slack = verify_slack
        self.overflow_fallback = overflow_fallback
        self.scored = scored
        self.seed_probes = seed_probes
        self.staircase_slots = staircase_slots
        self.staircase_narrow_left = staircase_narrow_left
        self._fb: "SuffixFilterAligner | None" = None
        self._fb2: "SuffixFilterAligner | None" = None
        if use_staircase:
            from . import bidirectional as bd

            if device_tables is not None and device_tables.get("rev") is not None:
                self.bi = bd.DeviceBiIndex(self.fm, device_tables["rev"])
            else:
                self.bi = bd.from_host_bi(gi.fwd, gi.rev)

    def _strand_pass(self, search_reads, verify_reads, lengths):
        """One strand: candidates -> verify -> per-read best (device)."""
        import jax.numpy as jnp

        L = search_reads.shape[1]
        W = L + 3 * self.k
        if self.use_staircase:
            from . import staircase

            cands = staircase.staircase_filter_candidates(
                self.bi,
                jnp.asarray(search_reads),
                jnp.asarray(lengths),
                self.k,
                n_slots=self.staircase_slots,
                max_hits=self.max_hits,
                narrow_left=self.staircase_narrow_left,
            )
        else:
            min_piece = int(lengths.min()) // self.n_pieces
            if self.seed_tab is not None and min_piece >= self.seed_j:
                cands = suffix_filter.seed_candidates(
                    self.seed_tab[0],
                    self.seed_tab[1],
                    jnp.asarray(search_reads),
                    jnp.asarray(lengths),
                    self.n_pieces,
                    self.seed_j,
                    max_hits=self.max_hits,
                    max_cands=self.max_cands,
                    n_probes=self.seed_probes,
                )
            else:
                cands = suffix_filter.pigeonhole_candidates(
                    self.fm,
                    jnp.asarray(search_reads),
                    jnp.asarray(lengths),
                    self.n_pieces,
                    self.max_hits,
                    kmer_tab=self.kmer_tab,
                    kmer_j=self.kmer_j,
                    kmer_full_cover=bool(self.kmer_j and min_piece >= self.kmer_j),
                    max_cands=self.max_cands,
                )
        if self.verify_slack and self.verify_mode == "banded":
            import jax.numpy as jnp

            dist_c, cp_c, rid_c, ovf2 = suffix_filter.verify_candidates_compact(
                self.text_words,
                self.fm.n,
                jnp.asarray(verify_reads),
                jnp.asarray(lengths),
                cands.cand_pos,
                self.k,
                W,
                slack=self.verify_slack,
            )
            best = suffix_filter.best_hit_compact(
                rid_c, cp_c, dist_c, self.k, len(lengths)
            )
            # ONE transfer for all four results: each np.asarray is its own
            # queue-sync round-trip, and this return sits inside the
            # per-batch fallback tiers
            import jax

            return jax.device_get(
                (best.best_pos, best.best_dist, best.n_good,
                 cands.overflow | ovf2)
            )
        if self.verify_mode == "myers":
            nwords = (L + 31) // 32
            dist = suffix_filter.verify_candidates_myers(
                self.text_words,
                self.fm.n,
                jnp.asarray(verify_reads),
                jnp.asarray(lengths),
                cands.cand_pos,
                self.k,
                W,
                nwords,
            )
        else:
            dist, _ = suffix_filter.verify_candidates(
                self.text_words,
                self.fm.n,
                jnp.asarray(verify_reads),
                jnp.asarray(lengths),
                cands.cand_pos,
                self.k,
                W,
            )
        best = suffix_filter.best_hit(cands.cand_pos, dist, self.k)
        import jax

        return jax.device_get(
            (best.best_pos, best.best_dist, best.n_good, cands.overflow)
        )

    def align_batch(self, reads: list[Read]) -> list[ApproxHit | None]:
        """Submit + finish in one call (see align_batch_submit for the
        pipelined two-phase API used by streaming drivers)."""
        return self.align_batch_finish(self.align_batch_submit(reads))

    def align_batch_submit(self, reads: list[Read]):
        """List-of-Read wrapper over the array-native submit."""
        lengths = np.array([len(r) for r in reads], dtype=np.int32)
        verify_fwd = reads_to_batch_verify(reads)
        return ("reads", reads, self.align_arrays_submit(verify_fwd, lengths))

    def align_batch_finish(self, handle) -> list[ApproxHit | None]:
        _, reads, inner = handle
        return hits_from_arrays(self.align_arrays_finish(inner))

    def align_arrays_submit(self, verify_fwd: np.ndarray, lengths: np.ndarray):
        """Array-native submit: enqueue device work for a (B, L) code batch.

        jax dispatch is asynchronous: the fused step is enqueued without
        blocking, so a driver can submit batch N+1 before finishing batch N
        and overlap host assembly with device compute.  Contiguous arrays
        end-to-end — building a 32k-read batch by stacking per-read objects
        costs more host time than the whole device step, so streaming
        drivers (bench, FASTQ reader) should produce arrays directly."""
        import jax.numpy as jnp

        L = verify_fwd.shape[1]
        uniform = bool(np.all(lengths == L))

        if uniform and self.use_staircase:
            # fused tier-2 (VERDICT r4 ask #3): the whole staircase finish —
            # device RC, strand-stacked staircase filter, compact verify,
            # cross-strand best, fast-CIGAR hamming — in ONE jit with one
            # download.  The general path below costs two dispatch
            # round-trips plus host revcomp per call, inside every
            # fallback tier.
            rwords, nmask = pack_reads_2bit(verify_fwd)
            out_dev = fused_staircase_step(
                self.bi,
                self.text_words,
                jnp.asarray(rwords),
                jnp.asarray(nmask),
                jnp.asarray(lengths),
                L=L,
                k=self.k,
                W=L + 3 * self.k,
                n_slots=self.staircase_slots,
                max_hits=self.max_hits,
                verify_slack=self.verify_slack,
                narrow_left=self.staircase_narrow_left,
            )
            return ("uniform", lengths, verify_fwd, out_dev)
        if uniform:
            # fast path: ONE jit call, one 2-bit-packed upload, device RC
            min_piece = L // self.n_pieces
            use_seed = self.seed_tab is not None and min_piece >= self.seed_j
            rwords, nmask = pack_reads_2bit(verify_fwd)
            out_dev = fused_align_step(
                self.fm,
                self.text_words,
                self.kmer_tab,
                self.seed_tab if use_seed else None,
                jnp.asarray(rwords),
                jnp.asarray(nmask),
                jnp.asarray(lengths),
                L=L,
                k=self.k,
                n_pieces=self.n_pieces,
                max_hits=self.max_hits,
                kmer_j=self.kmer_j,
                kmer_full_cover=bool(self.kmer_j and min_piece >= self.kmer_j),
                max_cands=self.max_cands,
                W=L + 3 * self.k,
                seed_j=self.seed_j if use_seed else 0,
                verify_slack=self.verify_slack,
                seed_probes=self.seed_probes,
            )
            return ("uniform", lengths, verify_fwd, out_dev)
        return ("general", lengths, verify_fwd)

    def align_arrays_finish(self, handle) -> "ArrayHits":
        kind = handle[0]
        if kind == "uniform":
            _, lengths, verify_fwd, out_dev = handle
            packed = np.asarray(out_dev)  # blocks here, not at submit
            cand, dist, take_r, n_good, ovf, ham, o_min = _unpack_result(
                packed, self.k
            )
            strand = take_r.astype(np.int64)
            mapped = dist <= self.k
            verify_rc = None  # built lazily for slow-path reads only
        else:
            import jax.numpy as jnp

            _, lengths, verify_fwd = handle
            search_fwd = np.where(verify_fwd >= 4, 0, verify_fwd).astype(np.int32)
            verify_rc = revcomp_verify_batch(verify_fwd, lengths)
            search_rc = np.where(verify_rc >= 4, 0, verify_rc).astype(np.int32)

            if self.use_staircase:
                # ONE stacked pass for both strands: the staircase cost is
                # dominated by its ~2L sequential FM extension steps, which
                # are depth-bound at fallback-cohort widths — stacking fwd+rc
                # as 2B lanes halves the pass count for the same wall depth
                B0 = len(lengths)
                p2, d2, n2, o2 = self._strand_pass(
                    np.concatenate([search_fwd, search_rc]),
                    np.concatenate([verify_fwd, verify_rc]),
                    np.concatenate([lengths, lengths]),
                )
                pf, df, nf, of = p2[:B0], d2[:B0], n2[:B0], o2[:B0]
                pr, dr, nr, orv = p2[B0:], d2[B0:], n2[B0:], o2[B0:]
            else:
                pf, df, nf, of = self._strand_pass(search_fwd, verify_fwd, lengths)
                pr, dr, nr, orv = self._strand_pass(search_rc, verify_rc, lengths)

            # deterministic best across strands: (dist, pos, strand) order
            df = np.where(df <= self.k, df, 1 << 20)
            dr = np.where(dr <= self.k, dr, 1 << 20)
            take_r = (dr < df) | ((dr == df) & (pr < pf))
            dist = np.where(take_r, dr, df).astype(np.int64)
            cand = np.where(take_r, pr, pf).astype(np.int64)
            strand = take_r.astype(np.int64)
            mapped = dist <= self.k
            n_good = (nf + nr).astype(np.int64)
            ovf = of | orv

            # fast CIGAR path: pure-substitution alignments skip traceback
            vsel = np.where(strand[:, None] == 0, verify_fwd, verify_rc)
            ham, o_min = suffix_filter.offset_hamming(
                self.text_words,
                self.fm.n,
                jnp.asarray(vsel),
                jnp.asarray(lengths),
                jnp.asarray(np.where(mapped, cand, 0).astype(np.int32)),
                self.k,
            )
            import jax

            ham, o_min = jax.device_get((ham, o_min))  # one sync, not two

        # vectorised assembly: pure-substitution alignments (the fast path)
        # resolve entirely with array ops; only indel reads need traceback
        fast = mapped & (ham == dist)
        pos = np.where(mapped, cand - self.k + o_min, 0)
        ws_all = cand - self.k
        cigars: dict[int, str] = {}
        aux: dict[int, tuple[int, int]] = {}

        slow_idx = np.nonzero(mapped & ~fast)[0]
        if slow_idx.size:
            # slow path (indels): ONE banded DP + lockstep traceback over the
            # whole cohort (ops.dp.traceback_banded_batch) — replaces the old
            # ~5 ms/read full-matrix host DP
            S = int(slow_idx.size)
            lmax = int(lengths[slow_idx].max())
            Wb = lmax + 3 * self.k
            vcodes = np.zeros((S, lmax), dtype=np.int64)
            lens_s = np.empty(S, dtype=np.int64)
            for t, i in enumerate(slow_idx):
                l = int(lengths[i])
                lens_s[t] = l
                st = int(strand[i])
                if verify_rc is None:  # uniform fast path: build RC lazily
                    row = verify_fwd[i]
                    vc = (
                        row
                        if st == 0
                        else dna.revcomp(row.astype(np.uint8)).astype(row.dtype)
                    )
                else:
                    vc = vsel[i]
                vcodes[t, :l] = vc[:l]
            # traceback windows decoded on HOST (vectorised, out-of-range
            # -> 4): a device gather here — however tiny — enqueues behind
            # the NEXT pipelined batch's compute on the in-order queue and
            # stalls every finish; when no host text is available, fall
            # back to the device gather
            from ..ops import window as window_ops

            if self.text_host is not None:
                wins = window_ops.gather_windows_host(
                    self.text_host, self.fm.n, ws_all[slow_idx], Wb
                ).astype(np.int64)
            else:
                import jax.numpy as jnp

                G = max(128, 1 << (S - 1).bit_length())
                gs = np.concatenate(
                    [ws_all[slow_idx], np.full(G - S, ws_all[slow_idx[0]])]
                )
                wins = np.asarray(
                    window_ops.gather_windows(
                        self.text_words, self.fm.n,
                        jnp.asarray(gs.astype(np.int32)), Wb,
                    )
                )[:S].astype(np.int64)
            if self.scored:
                # scored emission: the affine engine alone supplies
                # CIGAR/POS/NM/AS; ``dist`` is already the banded edit
                # distance from the device verify, so the unit-cost
                # traceback would recompute it for nothing (VERDICT r2
                # weak-#4: the slow cohort ran BOTH host DPs).  Selection
                # stays edit-distance (the filter's completeness guarantee).
                from ..ops import affine

                sc_s, astart_s, acig_s, nm_s = affine.affine_banded_batch(
                    vcodes, lens_s, wins, self.k
                )
                # clamp: a traceback beginning in the left pad of a window
                # that overhangs the genome start must not go negative
                pos[slow_idx] = np.maximum(ws_all[slow_idx] + astart_s, 0)
                for t, i in enumerate(slow_idx):
                    cigars[int(i)] = acig_s[t]
                    aux[int(i)] = (int(sc_s[t]), int(nm_s[t]))
            else:
                dist_s, start_s, cig_s = dp_ops.traceback_banded_batch(
                    vcodes, lens_s, wins, self.k
                )
                pos[slow_idx] = np.maximum(ws_all[slow_idx] + start_s, 0)
                dist[slow_idx] = dist_s
                for t, i in enumerate(slow_idx):
                    cigars[int(i)] = cig_s[t]
        self.last_stats = {
            "n_slow_traceback": int(slow_idx.size),
            "n_mapped": int(mapped.sum()),
        }
        ah = ArrayHits(
            mapped=mapped,
            pos=pos,
            strand=strand,
            dist=dist,
            n_good=np.asarray(n_good),
            overflow=np.asarray(ovf),
            lengths=np.asarray(lengths),
            cigars=cigars,
            aux=aux,
        )
        if self.overflow_fallback and bool(ah.overflow.any()):
            ah = self._apply_overflow_fallback(ah, verify_fwd, np.asarray(lengths))
        return ah

    FB_CHUNK = 4096  # tier-1 rerun chunk size: bounds the fallback step's
    # verify temps (bucket x max_cands x ~16L bytes ~= 4096 x 192 x 155 B
    # ~= 122 MB of windows + DP temps) so they fit beside multi-GB
    # Gbp-part tables; one compile shape for any cohort size.  Raised from
    # 1024 so the repeat bench's ~3.3k-read cohort runs as one chunk, not
    # four serial dispatches.  Chosen on the previous accelerator; to be
    # re-derived on the GPU.

    FB_MULT = 16  # tier-1 fallback budget multiplier.  On the repeat bench
    # cohort (7,967 flooded reads of 32k, chr20-scale 25%-repeat genome):
    # x4 leaves 1,939 reads for the staircase, x16 leaves 236, x32 187.
    # The staircase tier runs sequential FM extensions per read, so
    # shrinking its cohort 8x paid for the wider tier-1 verify up to x16.
    # The sweep's times came from the previous accelerator; to be
    # re-derived on the GPU.

    def _get_fb(self) -> "SuffixFilterAligner":
        """Fallback aligner: FB_MULT-x hit/candidate budgets, per-read
        verify lanes.

        Shares the device-resident index/tables with the primary (copy, not
        rebuild — no duplicate HBM), differs only in static budgets, so its
        fused step compiles separately under the global jit cache."""
        if self._fb is None:
            import copy

            fb = copy.copy(self)
            # absolute caps matter when the PRIMARY budgets are already
            # Gbp-scaled (multipart parts run max_hits=35): 16x on top of
            # that compiled a fallback step whose verify temps
            # (~cohort x max_cands x 16L bytes) alone exceeded the previous
            # accelerator's memory next to 8.7 GB of tables.  256/192 keep the 64-230 Mbp defaults
            # (8/12 -> 128/192) bit-for-bit unchanged.
            fb.max_hits = min(self.max_hits * self.FB_MULT, 256)
            fb.max_cands = min(self.max_cands * self.FB_MULT, 192)
            fb.verify_slack = 0
            fb.overflow_fallback = False
            fb._fb = None
            fb._fb2 = None
            self._fb = fb
        return self._fb

    def _get_fb2(self) -> "SuffixFilterAligner | None":
        """Tier-2 fallback: staircase bidirectional interval narrowing.

        Budget truncation cannot fix a read whose every seed bucket is
        flooded by a repeat family (thousands of copies; VERDICT r2
        missing-#1): the per-bucket slot sample rarely contains the read's
        own diverged copy.  The staircase search (models.staircase — the
        reference SuffixFilter's actual method) extends matches across the
        WHOLE read in FM space under the mismatch budget, so intervals
        narrow to loci within k substitutions of the read — a tiny set even
        inside a repeat family.  Complete for <=k-substitution alignments;
        merge below is improve-only, so indel alignments found by the seed
        path are never lost.  Requires the reverse-text index (gi.rev)."""
        if self._fb2 is None and self.gi.rev is not None and not self.use_staircase:
            self._fb2 = SuffixFilterAligner(
                self.gi,
                k=self.k,
                max_hits_per_piece=self.max_hits,
                use_staircase=True,
                verify_slack=16,
                overflow_fallback=False,
                scored=self.scored,
                staircase_slots=self.staircase_slots,  # sweepable (r5 ask #3)
            )
        return self._fb2

    def _apply_overflow_fallback(
        self, ah: "ArrayHits", verify_fwd: np.ndarray, lengths: np.ndarray
    ) -> "ArrayHits":
        """Rerun budget-overflowed reads through the fallback aligner.

        The fallback searches a strict superset (bigger budgets, no shared
        verify pool), so its result replaces the primary's wholesale.  The
        subset is padded to a power-of-two bucket so recompiles are bounded.

        Cohort policy (VERDICT r3 weak-#4): only UNMAPPED overflowed reads
        rerun.  A read that mapped despite budget truncation keeps its hit
        with the XO multiplicity-floor flag — rerunning all ~8k flooded
        reads of a repeat batch would only improve ~4.8k already-mapped
        repeat reads whose best hit is another <=k copy of the same family
        either way; restricting to the unmapped cohort keeps the mapped
        fraction identical at under half the tier-1 work.
        """
        import time as _time

        idx = np.nonzero(ah.overflow & ~ah.mapped)[0]
        if idx.size == 0:
            return ah
        _t0 = _time.perf_counter()
        fb = self._get_fb()
        # device downloads arrive read-only; copy the fields being patched
        writable = lambda a: a if a.flags.writeable else a.copy()
        ah = ah._replace(
            mapped=writable(ah.mapped), pos=writable(ah.pos),
            strand=writable(ah.strand), dist=writable(ah.dist),
            n_good=writable(ah.n_good), overflow=writable(ah.overflow),
        )
        n = idx.size
        # Chunked rerun: the fallback's verify temps scale with
        # bucket x max_cands x L — one whole-cohort bucket next to
        # Gbp-part tables (8.7 GB) wedged the runtime in allocation
        # retry.  Fixed-size chunks bound the temps AND give a single
        # compile shape; cohorts <= FB_CHUNK keep the old power-of-two
        # bucket (bit-identical shapes for the small-genome benches).
        CH = self.FB_CHUNK
        if n <= CH:
            P = max(128, 1 << (int(n) - 1).bit_length())
            chunks = [(idx, P)]
        else:
            chunks = [(idx[o : o + CH], CH) for o in range(0, n, CH)]

        def _submit(ch, P):
            sel = np.concatenate([ch, np.full(P - ch.size, ch[0], ch.dtype)])
            return fb.align_arrays_submit(verify_fwd[sel], lengths[sel])

        still_parts = []
        pending = _submit(*chunks[0])
        prefetch_result(pending)
        for ci, (ch, P) in enumerate(chunks):
            nxt = _submit(*chunks[ci + 1]) if ci + 1 < len(chunks) else None
            prefetch_result(nxt)
            fh = fb.align_arrays_finish(pending)
            pending = nxt
            m = ch.size
            ah.mapped[ch] = fh.mapped[:m]
            ah.pos[ch] = fh.pos[:m]
            ah.strand[ch] = fh.strand[:m]
            ah.dist[ch] = fh.dist[:m]
            ah.n_good[ch] = fh.n_good[:m]
            ah.overflow[ch] = fh.overflow[:m]  # still set if even capped-x overflowed
            for t, i in enumerate(ch.tolist()):
                if t in fh.cigars:
                    ah.cigars[i] = fh.cigars[t]
                else:
                    ah.cigars.pop(i, None)
                if t in fh.aux:
                    ah.aux[i] = fh.aux[t]
                else:
                    ah.aux.pop(i, None)
            still_parts.append(
                ch[
                    np.asarray(fh.overflow[:m], dtype=bool)
                    & ~np.asarray(fh.mapped[:m], dtype=bool)
                ]
            )
        self.last_stats["n_overflow_fallback"] = int(n)
        self.last_stats["t_tier1_ms"] = round(
            (_time.perf_counter() - _t0) * 1e3, 1
        )
        _t0 = _time.perf_counter()

        # tier 2: reads STILL overflowed after FB_MULT-x budgets AND unmapped go
        # through the staircase narrowing search (see _get_fb2).  Mapped-but-
        # overflowed reads are not re-searched: their XO flag already marks
        # the multiplicity floor, and staircase time is reserved for reads
        # that would otherwise be silently lost.
        still = np.concatenate(still_parts) if still_parts else idx[:0]
        fb2 = self._get_fb2() if still.size else None
        self.last_stats["n_staircase_fallback"] = int(still.size) if fb2 is not None else 0
        if fb2 is not None:
            P2 = max(128, 1 << (int(still.size) - 1).bit_length())
            sel2 = np.concatenate(
                [still, np.full(P2 - still.size, still[0], still.dtype)]
            )
            fh2 = fb2.align_arrays_finish(
                fb2.align_arrays_submit(verify_fwd[sel2], lengths[sel2])
            )
            m = still.size
            # improve-only merge: take the staircase hit when it maps an
            # unmapped read or strictly lowers the distance; the overflow
            # flag STAYS set (n_good from a flooded region is a floor)
            better = np.asarray(fh2.mapped[:m], bool) & (
                ~ah.mapped[still] | (fh2.dist[:m] < ah.dist[still])
            )
            rows = still[better]
            ah.mapped[rows] = True
            ah.pos[rows] = fh2.pos[:m][better]
            ah.strand[rows] = fh2.strand[:m][better]
            ah.dist[rows] = fh2.dist[:m][better]
            ah.n_good[rows] = fh2.n_good[:m][better]
            for t, i in zip(np.nonzero(better)[0].tolist(), rows.tolist()):
                if t in fh2.cigars:
                    ah.cigars[i] = fh2.cigars[t]
                else:
                    ah.cigars.pop(i, None)
                if t in fh2.aux:
                    ah.aux[i] = fh2.aux[t]
                else:
                    ah.aux.pop(i, None)
        self.last_stats["t_tier2_ms"] = round(
            (_time.perf_counter() - _t0) * 1e3, 1
        )
        return ah

    def to_sam_lines(
        self,
        names,
        codes: np.ndarray,
        lengths: np.ndarray,
        ah: "ArrayHits",
        quals: np.ndarray | None = None,
    ) -> list[str]:
        """Vectorised SAM emission straight from ArrayHits — the array-native
        fast path (column-wise assembly; see utils.sam.lines_from_arrays).
        Byte-identical to ``to_sam`` for every mapped read; unmapped
        overflow rows additionally carry XO:i:1 (the object path cannot,
        because ``hits_from_arrays`` folds unmapped rows to None)."""
        return sam.lines_from_arrays(
            names,
            codes,
            lengths,
            ah,
            self.gi.genome.names,
            np.asarray(self.gi.genome.offsets),
            quals=quals,
            scored=getattr(self, "scored", False),
        )

    def to_sam(self, reads: list[Read], hits) -> list[sam.SamRecord]:
        recs = []
        for r, h in zip(reads, hits):
            if h is None:
                recs.append(sam.unmapped(r.name, r.codes, r.qual))
                continue
            ci, local = self.gi.genome.coord(h.pos)
            # native AS: slow-path reads carry the affine traceback's score;
            # fast-path alignments are all-M with h.dist mismatches, whose
            # affine score is exact in closed form (no gaps)
            if h.score is not None:
                score, nm = h.score, h.nm
            elif getattr(self, "scored", False):
                score = 1 * (len(r) - h.dist) - 4 * h.dist
                nm = h.dist
            else:
                score, nm = None, h.dist
            recs.append(
                sam.mapped(
                    r.name,
                    r.codes,
                    self.gi.genome.names[int(ci[0])],
                    int(local[0]),
                    h.strand,
                    h.cigar,
                    edit_distance=nm,
                    mapq=37 if h.n_good == 1 else (3 if h.n_good > 1 else 0),
                    qual=r.qual,
                    n_hits=h.n_good,
                    overflow=h.overflow,
                    score=score,
                )
            )
        return recs

    def sam_header(self) -> str:
        return sam.header(self.gi.genome.names, self.gi.genome.lengths)


def reads_to_batch_verify(reads: list[Read]) -> np.ndarray:
    """(B, L) int32 with N kept as 4 (counts as an edit in verify)."""
    L = max(len(r) for r in reads)
    if all(len(r) == L for r in reads):  # uniform: one vectorised stack
        return np.stack([r.codes for r in reads]).astype(np.int32)
    out = np.zeros((len(reads), L), dtype=np.int32)
    for i, r in enumerate(reads):
        out[i, : len(r)] = r.codes
    return out


def revcomp_verify_batch(batch: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    L = batch.shape[1]
    if np.all(lengths == L):  # uniform-length fast path
        rc = batch[:, ::-1]
        return np.where(rc < 4, 3 - rc, rc).astype(batch.dtype)
    out = np.zeros_like(batch)
    for i in range(batch.shape[0]):
        l = int(lengths[i])
        out[i, :l] = dna.revcomp(batch[i, :l].astype(np.uint8))
    return out


def pack_reads_2bit(verify_fwd: np.ndarray):
    """Host-side 2-bit pack of a (B, L) verify-code batch + N bitmask.

    2 bits/base + 1 N-mask bit cuts the per-batch upload ~3.5x against
    int8 codes (6.5 MB at 65k reads of 100 bp); the device unpacks with two
    shifts inside the fused step.  Whether the saving still pays over the
    GPU's host link is not measured yet."""
    B, L = verify_fwd.shape
    W16 = (L + 15) // 16
    W32 = (L + 31) // 32
    # byte-wise pack (uint8 ops on L/4 columns, then a little-endian u32
    # view — bit k of word w is base 16w + k/2, matching the device
    # unpack); an all-u32 formulation cost more host time than the
    # transfer saving it bought
    c = np.zeros((B, W16 * 16), np.uint8)
    cl = verify_fwd.astype(np.uint8, copy=False)
    isn = cl >= 4
    c[:, :L] = np.where(isn, 0, cl)
    b4 = (
        c[:, 0::4]
        | (c[:, 1::4] << 2)
        | (c[:, 2::4] << 4)
        | (c[:, 3::4] << 6)
    )
    rwords = np.ascontiguousarray(b4).view("<u4")
    nm = np.packbits(isn, axis=1, bitorder="little")
    nmb = np.zeros((B, W32 * 4), np.uint8)
    nmb[:, : nm.shape[1]] = nm
    nmask = nmb.view("<u4")
    return rwords, nmask


def _unpack_reads_2bit(rwords, nmask, L: int):
    """Device-side inverse of pack_reads_2bit -> (B, L) int32 verify codes."""
    import jax.numpy as jnp

    pos = jnp.arange(L, dtype=jnp.int32)
    w = rwords[:, pos // 16]
    code = (w >> (2 * (pos % 16)).astype(jnp.uint32)) & jnp.uint32(3)
    nb = (nmask[:, pos // 32] >> (pos % 32).astype(jnp.uint32)) & jnp.uint32(1)
    return jnp.where(nb != 0, jnp.int32(4), code.astype(jnp.int32))


def _pack_result(cand, dist, take_r, n_good, ovf, ham, o_min, k):
    """Pack the per-read result columns into TWO int32 rows (bitfield) —
    the download is 8 bytes/read instead of 28.  Saturations are
    harmless: dist saturates at 15 (> any k <= 4 = unmapped), ham at 511
    (only compared against dist <= k), o_min at 31 (range <= 3k), n_good
    at 255 (the SAM X0 cap is 8)."""
    import jax.numpy as jnp

    bf = (
        jnp.clip(dist, 0, 15)
        | (take_r.astype(jnp.int32) << 4)
        | (ovf.astype(jnp.int32) << 5)
        | (jnp.clip(o_min, 0, 31) << 6)
        | (jnp.clip(ham, 0, 511) << 11)
        | (jnp.clip(n_good, 0, 255) << 20)
    )
    return jnp.stack([cand, bf])


_RESULT_INF = 1 << 20


def _unpack_result(packed: np.ndarray, k: int):
    """Host-side inverse of _pack_result -> the 7 result columns."""
    cand = packed[0].astype(np.int64)
    bf = packed[1]
    dist = (bf & 15).astype(np.int64)
    dist = np.where(dist > k, _RESULT_INF, dist)  # 15 == saturated INF
    take_r = (bf >> 4) & 1
    ovf = ((bf >> 5) & 1).astype(bool)
    o_min = (bf >> 6) & 31
    ham = (bf >> 11) & 511
    n_good = ((bf >> 20) & 255).astype(np.int64)
    return cand, dist, take_r, n_good, ovf, ham, o_min


def _fused_align_step_impl(
    fm, text_words, kmer_tab, seed_tab, rwords, nmask, lengths,
    *, L, k, n_pieces, max_hits, kmer_j, kmer_full_cover, max_cands, W,
    seed_j=0, verify_slack=0, seed_probes=suffix_filter.SEED_PROBES,
):
    """Whole per-batch device step in one jit: both strands, candidate
    generation, verify, cross-strand best, fast-CIGAR hamming check.

    One 2-bit-packed upload (+ N mask), one packed 2-row int32 download —
    minimizes host<->device transfer bytes and dispatch round trips.
    Uniform-length batches only (device-side reverse complement)."""
    import jax
    import jax.numpy as jnp

    from ..ops import dp as dp_ops

    INF = dp_ops.INF
    vf = _unpack_reads_2bit(rwords, nmask, L)
    vrc = jnp.where(vf < 4, 3 - vf, vf)[:, ::-1]

    # two sequential strand passes: on the previous accelerator the device
    # was already throughput-bound at 32k lanes, so stacking to 2B lanes
    # bought no latency and cost more in the wider sorts (not re-measured
    # on the GPU)
    def strand_pass(vcodes):
        search = jnp.where(vcodes >= 4, 0, vcodes).astype(jnp.int32)
        if seed_tab is not None and seed_j > 0:
            cands = suffix_filter.seed_candidates(
                seed_tab[0], seed_tab[1], search, lengths, n_pieces, seed_j,
                max_hits=max_hits, max_cands=max_cands, n_probes=seed_probes,
            )
        else:
            cands = suffix_filter.pigeonhole_candidates(
                fm, search, lengths, n_pieces, max_hits,
                kmer_tab=kmer_tab, kmer_j=kmer_j, kmer_full_cover=kmer_full_cover,
                max_cands=max_cands,
            )
        if verify_slack:
            dist_c, cp_c, rid_c, ovf2 = suffix_filter.verify_candidates_compact(
                text_words, fm.n, vcodes.astype(jnp.int32), lengths,
                cands.cand_pos, k, W, slack=verify_slack,
            )
            best = suffix_filter.best_hit_compact(
                rid_c, cp_c, dist_c, k, vcodes.shape[0]
            )
            return best, cands.overflow | ovf2
        dist, _ = suffix_filter.verify_candidates(
            text_words, fm.n, vcodes.astype(jnp.int32), lengths,
            cands.cand_pos, k, W,
        )
        best = suffix_filter.best_hit(cands.cand_pos, dist, k)
        return best, cands.overflow

    bf, ovf_f = strand_pass(vf)
    br, ovf_r = strand_pass(vrc)

    df = jnp.where(bf.best_dist <= k, bf.best_dist, INF)
    dr = jnp.where(br.best_dist <= k, br.best_dist, INF)
    take_r = (dr < df) | ((dr == df) & (br.best_pos < bf.best_pos))
    dist = jnp.where(take_r, dr, df)
    cand = jnp.where(take_r, br.best_pos, bf.best_pos)
    n_good = bf.n_good + br.n_good
    ovf = ovf_f | ovf_r
    mapped = dist <= k

    vsel = jnp.where(take_r[:, None], vrc, vf)
    ham, o_min = suffix_filter.offset_hamming(
        text_words, fm.n, vsel.astype(jnp.int32), lengths,
        jnp.where(mapped, cand, 0).astype(jnp.int32), k,
    )
    return _pack_result(cand, dist, take_r, n_good, ovf, ham, o_min, k)


_fused_cache: dict = {}


def fused_align_step(fm, text_words, kmer_tab, seed_tab, rwords, nmask, lengths, **static):
    """jit-cached wrapper (static config in the cache key)."""
    import jax
    from functools import partial

    key = tuple(sorted(static.items())) + (kmer_tab is not None, seed_tab is not None)
    if key not in _fused_cache:
        _fused_cache[key] = jax.jit(
            partial(_fused_align_step_impl, **static)
        )
    return _fused_cache[key](fm, text_words, kmer_tab, seed_tab, rwords, nmask, lengths)


def _fused_staircase_step_impl(
    bi, text_words, rwords, nmask, lengths, *, L, k, W, n_slots, max_hits,
    verify_slack, narrow_left=False,
):
    """Whole staircase (tier-2) step in one jit: device RC, BOTH strands
    stacked into one 2B-lane staircase pass (the staircase is depth-bound,
    so stacking halves the sequential pass count — VERDICT r3 weak-#4),
    compact verify, cross-strand best, fast-CIGAR hamming.  Packing is
    identical to ``_fused_align_step_impl`` so the finish path is shared."""
    import jax.numpy as jnp

    from ..ops import dp as dp_ops
    from . import staircase

    INF = dp_ops.INF
    vf = _unpack_reads_2bit(rwords, nmask, L)
    B = vf.shape[0]
    vrc = jnp.where(vf < 4, 3 - vf, vf)[:, ::-1]
    v2 = jnp.concatenate([vf, vrc], axis=0)
    search2 = jnp.where(v2 >= 4, 0, v2).astype(jnp.int32)
    lengths2 = jnp.concatenate([lengths, lengths], axis=0)

    cands = staircase.staircase_filter_candidates(
        bi, search2, lengths2, k, n_slots=n_slots, max_hits=max_hits,
        narrow_left=narrow_left,
    )
    if verify_slack:
        dist_c, cp_c, rid_c, ovf2 = suffix_filter.verify_candidates_compact(
            text_words, bi.fwd.n, v2.astype(jnp.int32), lengths2,
            cands.cand_pos, k, W, slack=verify_slack,
        )
        best = suffix_filter.best_hit_compact(rid_c, cp_c, dist_c, k, 2 * B)
        ovf2b = cands.overflow | ovf2
    else:
        dist2, _ = suffix_filter.verify_candidates(
            text_words, bi.fwd.n, v2.astype(jnp.int32), lengths2,
            cands.cand_pos, k, W,
        )
        best = suffix_filter.best_hit(cands.cand_pos, dist2, k)
        ovf2b = cands.overflow

    df = jnp.where(best.best_dist[:B] <= k, best.best_dist[:B], INF)
    dr = jnp.where(best.best_dist[B:] <= k, best.best_dist[B:], INF)
    pf, pr = best.best_pos[:B], best.best_pos[B:]
    take_r = (dr < df) | ((dr == df) & (pr < pf))
    dist = jnp.where(take_r, dr, df)
    cand = jnp.where(take_r, pr, pf)
    n_good = best.n_good[:B] + best.n_good[B:]
    ovf = ovf2b[:B] | ovf2b[B:]
    mapped = dist <= k

    vsel = jnp.where(take_r[:, None], vrc, vf)
    ham, o_min = suffix_filter.offset_hamming(
        text_words, bi.fwd.n, vsel.astype(jnp.int32), lengths,
        jnp.where(mapped, cand, 0).astype(jnp.int32), k,
    )
    return _pack_result(cand, dist, take_r, n_good, ovf, ham, o_min, k)


def fused_staircase_step(bi, text_words, rwords, nmask, lengths, **static):
    """jit-cached wrapper (static config in the cache key)."""
    import jax
    from functools import partial

    key = ("staircase",) + tuple(sorted(static.items()))
    if key not in _fused_cache:
        _fused_cache[key] = jax.jit(partial(_fused_staircase_step_impl, **static))
    return _fused_cache[key](bi, text_words, rwords, nmask, lengths)
