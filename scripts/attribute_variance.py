"""Attribute the headline bench's batch-time variance (identical
65,536-read batches can differ several-fold in wall time within one run;
find the stall before optimizing anything else).

Three phases over the SAME read stream / aligner / shapes:

A. depth-1 pipelined loop (the bench's loop): per batch records the
   submit wall time (host assembly + async dispatch) and the finish wall
   time (queue drain + one device->host fetch).
B. enqueue-all-then-drain: submit every batch before finishing any.  The
   device queue then holds all compute back-to-back, so per-finish wall
   times become arrival times of a saturated pipeline; if
   total/batches ~= the phase-A minimum, device work is uniform and the
   phase-A spread lives in the submit/finish interleave (host work or
   host<->device round trips); if the drain still swings, the stall is on
   the device itself.
C. depth-D pipelining (D=3): does a deeper in-flight queue ride out
   host-side bursts?  If C's sustained >> A's sustained, the fix is a
   deeper submit window in the production loop.

Usage: python scripts/attribute_variance.py [--batches 24] [--depth 3]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import CHR20, SEED_J, build_or_load_index, load_seed_table, sim_sub_reads  # noqa: E402


def summarize(name, bt):
    bt = np.asarray(bt) * 1e3
    print(
        f"{name}: n={bt.size} min={bt.min():.0f} p25={np.percentile(bt,25):.0f} "
        f"med={np.median(bt):.0f} p75={np.percentile(bt,75):.0f} "
        f"max={bt.max():.0f} ms  sum={bt.sum()/1e3:.2f}s"
    )
    return bt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--batch-size", type=int, default=65_536)
    ap.add_argument("--depth", type=int, default=3)
    args = ap.parse_args()

    from genome_weaver_align.utils import compile_cache

    compile_cache.enable()

    from genome_weaver_align.index.files import Genome, GenomeIndex
    from genome_weaver_align.models.pipeline import (
        SuffixFilterAligner,
        prefetch_result,
    )

    B, NB = args.batch_size, args.batches
    codes, fm = build_or_load_index(CHR20, tag="chr20_r8", sample_rate=8)
    genome = Genome(
        names=["chr20s"], offsets=np.array([0, codes.size], dtype=np.int64),
        codes=codes, n_mask_spans=np.zeros((0, 2), np.int64),
    )
    gi = GenomeIndex(genome, fm, None)
    so, sp = load_seed_table(codes, "chr20", SEED_J)
    al = SuffixFilterAligner(
        gi, k=2, max_hits_per_piece=8, seed_table=(so, sp), seed_j=SEED_J,
        max_cands=12, verify_slack=4,
    )
    print("simulating reads...")
    rarr, _tp, _ts = sim_sub_reads(codes, B * NB, 100, seed=3, max_subs=2)
    rarr = rarr.astype(np.int8)
    lens = np.full(B, 100, dtype=np.int32)

    def submit(b):
        return al.align_arrays_submit(rarr[b * B : (b + 1) * B], lens)

    al.align_arrays_finish(submit(0))  # compile + warm
    print("warm.")

    # ---- A: depth-1 ----
    sub_t, fin_t, tot_t = [], [], []
    pending = submit(0)
    prefetch_result(pending)
    t_all = time.perf_counter()
    for b in range(NB):
        tb = time.perf_counter()
        nxt = submit(b + 1) if b + 1 < NB else None
        prefetch_result(nxt)
        t1 = time.perf_counter()
        al.align_arrays_finish(pending)
        t2 = time.perf_counter()
        pending = nxt
        sub_t.append(t1 - tb)
        fin_t.append(t2 - t1)
        tot_t.append(t2 - tb)
    a_wall = time.perf_counter() - t_all
    summarize("A submit", sub_t)
    summarize("A finish", fin_t)
    a = summarize("A total ", tot_t)
    print(f"A wall {a_wall:.2f}s -> {B*NB/a_wall:,.0f} reads/s sustained")

    # ---- B: enqueue all, then drain ----
    t_all = time.perf_counter()
    handles = [submit(b) for b in range(NB)]
    t_submit_all = time.perf_counter() - t_all
    drain = []
    for h in handles:
        t0 = time.perf_counter()
        al.align_arrays_finish(h)
        drain.append(time.perf_counter() - t0)
    b_wall = time.perf_counter() - t_all
    print(f"B submit-all: {t_submit_all:.2f}s")
    summarize("B drain  ", drain)
    print(f"B wall {b_wall:.2f}s -> {B*NB/b_wall:,.0f} reads/s sustained")

    # ---- C: depth-D ----
    D = args.depth
    t_all = time.perf_counter()
    inflight = [submit(b) for b in range(min(D, NB))]
    ct = []
    for b in range(NB):
        t0 = time.perf_counter()
        if b + D < NB:
            inflight.append(submit(b + D))
        al.align_arrays_finish(inflight[b])
        inflight[b] = None  # free
        ct.append(time.perf_counter() - t0)
    c_wall = time.perf_counter() - t_all
    summarize(f"C d={D}   ", ct)
    print(f"C wall {c_wall:.2f}s -> {B*NB/c_wall:,.0f} reads/s sustained")


if __name__ == "__main__":
    main()
