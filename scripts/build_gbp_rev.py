"""Add reverse-text FM indexes to an existing multi-part gbp index.

The streaming multipart aligner's completeness backstop (staircase tier-2,
`models.staircase`) needs the reverse-text index of each part.  This script
derives it from the part's packed text (no genome regeneration): unpack ->
reverse -> native SA-IS -> FM tables -> part{i}_rev.npz.

The rev index serves ONLY bidirectional interval extension (occ/C/primary)
plus the standard marks/ssa fields; sample_rate is raised to 64 to keep its
device footprint ~1.75 GB next to the 8.67 GB forward tables.

Usage: python scripts/build_gbp_rev.py [--parts bench_cache/gbp_parts]
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import sys

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from genome_weaver_align.index.build import build_fm_index  # noqa: E402
from genome_weaver_align.utils import packing  # noqa: E402

T0 = time.time()


def log(m):
    print(f"[gbp-rev + {time.time()-T0:7.1f}s] {m}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="bench_cache/gbp_parts")
    args = ap.parse_args()
    part_dir = Path(args.parts)
    meta = json.loads((part_dir / "parts.json").read_text())

    for i in range(meta["n_parts"]):
        out = part_dir / f"part{i}_rev.npz"
        if out.exists():
            log(f"part {i}: rev exists, skipping")
            continue
        z = np.load(part_dir / f"part{i}.npz")
        n = int(z["n"])
        t = time.time()
        codes = packing.unpack(z["text_words"], n)
        rev_codes = codes[::-1].copy()
        del codes
        log(f"part {i}: unpacked+reversed {n} bp in {time.time()-t:.1f}s")
        t = time.time()
        rev = build_fm_index(rev_codes, sample_rate=64)
        del rev_codes
        log(f"part {i}: reverse FM built in {time.time()-t:.1f}s")
        t = time.time()
        marks = rev.ssa_marks.get(np.arange(rev.n + 1))
        np.savez(
            out,
            n=rev.n,
            primary=rev.primary,
            counts=rev.counts,
            C=rev.C,
            bwt_words=rev.bwt_words,
            occ_cp_i32=rev.occ_cp.astype(np.int32),
            sample_rate=rev.sample_rate,
            mark_bits=np.packbits(marks),
            ssa_values_i32=rev.ssa_values.astype(np.int32),
            text_words=rev.text_words,
        )
        log(f"part {i}: saved {out.name} in {time.time()-t:.1f}s")
    log("DONE")


if __name__ == "__main__":
    main()
