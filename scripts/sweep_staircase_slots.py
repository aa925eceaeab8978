"""Staircase pool-size sweep on the repeat bench (VERDICT r4 ask #3):
run the repeat-rich chr20-scale pipeline with staircase_slots in
{16, 32, 64} and record reads/s, mapped, correct and the overflow
fraction per setting — the r4 default of 16 tripled the XO rate
(0.067 -> 0.184) and the tradeoff was never measured.

Usage: python scripts/sweep_staircase_slots.py [--slots 16,32,64]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench import (  # noqa: E402
    CHR20, PIPE_BATCH, SEED_J, build_or_load_index, load_seed_table,
    _run_pipeline_batches, sustained_rate,
)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", default="16,32,64")
    ap.add_argument("--batches", type=int, default=6)
    args = ap.parse_args()

    from genome_weaver_align.utils import compile_cache

    compile_cache.enable()

    from genome_weaver_align.index.files import Genome, GenomeIndex
    from genome_weaver_align.models.pipeline import SuffixFilterAligner
    from genome_weaver_align.utils import simulate

    codes, fm, rev = build_or_load_index(
        CHR20, tag="chr20rep_r8", sample_rate=8,
        gen=lambda n: simulate.repeat_genome(n, seed=4), with_rev=True,
    )
    genome = Genome(
        names=["chr20rep"], offsets=np.array([0, codes.size], dtype=np.int64),
        codes=codes, n_mask_spans=np.zeros((0, 2), np.int64),
    )
    gi = GenomeIndex(genome, fm, rev)
    so, sp = load_seed_table(codes, "chr20rep", SEED_J)
    n_batches = args.batches
    rarr, true_pos, true_strand, _ = simulate.simulate_reads_array(
        codes, PIPE_BATCH * n_batches, 100, seed=13, max_subs=2
    )
    rarr = rarr.astype(np.int8)
    lengths_row = np.full(PIPE_BATCH, 100, dtype=np.int32)
    total = PIPE_BATCH * n_batches

    print(f"| slots | reads/s (min-pair) | sustained | mapped | correct | overflow |")
    print(f"|---|---|---|---|---|---|")
    for slots in [int(s) for s in args.slots.split(",")]:
        al = SuffixFilterAligner(
            gi, k=2, max_hits_per_piece=8, seed_table=(so, sp), seed_j=SEED_J,
            max_cands=12, verify_slack=4, staircase_slots=slots,
        )
        bt, n_mapped, n_correct, n_overflow, _ = _run_pipeline_batches(
            al, rarr, lengths_row, n_batches, tol_pos=0, true_pos=true_pos,
            true_strand=true_strand,
        )
        bt = np.asarray(bt)
        pair = (bt[:-1] + bt[1:]) / 2 if bt.size > 1 else bt
        rate = PIPE_BATCH / float(np.min(pair))
        sus = sustained_rate(bt, PIPE_BATCH)
        print(
            f"| {slots} | {rate:,.0f} | {sus:,.0f} | {n_mapped/total:.4f} | "
            f"{n_correct/total:.4f} | {n_overflow/total:.5f} |",
            flush=True,
        )
        del al


if __name__ == "__main__":
    main()
