"""Diagnose the gbp bench's unmapped tail (VERDICT r5 follow-up): every
final-unmapped read has a <=2-substitution locus (analyze_gbp_correct),
so the staircase rescue is dropping them — pool truncation, sampling, or
ordering.  This reruns JUST those reads through the flat-part rescue at
several pool settings and reports how many map at each.

Usage: python scripts/diag_gbp_unmapped.py [--slots 64,128] [--cache bench_cache]
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default="bench_cache")
    ap.add_argument("--slots", default="64,128")
    args = ap.parse_args()
    cache = Path(args.cache)

    import jax

    from genome_weaver_align.utils import compile_cache

    compile_cache.enable()

    from genome_weaver_align.index import multipart_io as mp
    from genome_weaver_align.index.files import GenomeIndex as GI
    from genome_weaver_align.models.pipeline import SuffixFilterAligner

    dbg = np.load(cache / "gbp_debug.npz")
    z = np.load(cache / "gbp_parts" / "reads.npz")
    N = dbg["dist"].size
    un = np.nonzero(dbg["dist"] > 2)[0]
    print(f"{un.size} unmapped of {N}")
    reads = z["reads"][:N].astype(np.int8)
    tg, ts = dbg["true_gpos"][un], dbg["true_strand"][un]
    L = reads.shape[1]
    mi = mp.load_multi_index(cache / "gbp_parts")

    P = max(128, 1 << (int(un.size) - 1).bit_length())
    sel = np.concatenate([un, np.full(P - un.size, un[0], un.dtype)])
    lens = np.full(P, L, np.int32)

    for p in range(mi.n_parts):
        t0 = time.time()
        fp = mp.load_part_flat(mi.part_dir, p, want_seed=False, want_fm=True)
        rev = mp.load_rev_flat(mi.part_dir, p)
        jax.block_until_ready((fp.fm.blocks, rev.blocks))
        print(f"part {p} loaded in {time.time()-t0:.0f}s")
        in_part = (tg >= fp.global_offset) & (
            tg < fp.global_offset + fp.n
        )
        for slots in [int(s) for s in args.slots.split(",")]:
            al2 = SuffixFilterAligner(
                GI(fp.genome, None, None), k=2, max_hits_per_piece=8,
                use_staircase=True, verify_slack=16, overflow_fallback=False,
                staircase_slots=slots,
                device_tables={"fm": fp.fm, "text": fp.text_words, "rev": rev},
            )
            t0 = time.time()
            ah = al2.align_arrays_finish(al2.align_arrays_submit(reads[sel], lens))
            m = un.size
            mapped = np.asarray(ah.mapped[:m])
            correct = mapped & (
                np.asarray(ah.pos[:m]) + fp.global_offset == tg
            ) & (np.asarray(ah.strand[:m]) == ts)
            print(
                f"part {p} slots={slots}: mapped {mapped.sum()}/{m} "
                f"(true-in-part {in_part.sum()}: mapped {mapped[in_part].sum()}, "
                f"exact {correct[in_part].sum()}), ovf "
                f"{np.asarray(ah.overflow[:m]).sum()}, {time.time()-t0:.1f}s"
            )
            del al2
        del fp, rev
        import gc

        gc.collect()


if __name__ == "__main__":
    main()
