"""One-time npz -> flat conversion of a multi-part gbp index directory.

The flat layout (index/multipart_io.py) stores device-ready raw arrays so
a 1.6 Gbp part loads via memmap + upload with zero host transformation
(the npz load took longer than the align itself).

Usage: python scripts/convert_gbp_flat.py [--parts bench_cache/gbp_parts]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from genome_weaver_align.index import multipart_io  # noqa: E402

T0 = time.time()


def log(m):
    print(f"[gbp-flat + {time.time()-T0:7.1f}s] {m}", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="bench_cache/gbp_parts")
    args = ap.parse_args()
    part_dir = Path(args.parts)
    meta = json.loads((part_dir / "parts.json").read_text())
    for i in range(meta["n_parts"]):
        multipart_io.convert_part_to_flat(part_dir, i, log=log)
    log("DONE")


if __name__ == "__main__":
    main()
