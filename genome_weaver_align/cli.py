"""Command-line interface (SURVEY.md §2 #16; reference `GenomeWeaver` main).

Subcommand verbs mirror the reference (`BWTransform` -> ``index``,
`BWAlign`/`SuffixFilter` align -> ``align``), plus ``simulate`` for synthetic
data and ``dump`` debug helpers.

    python -m genome_weaver_align index genome.fa -o genome.gwa.npz
    python -m genome_weaver_align align genome.gwa.npz reads.fq -k 2 -o out.sam
    python -m genome_weaver_align simulate genome.fa -n 1000 -l 100 -o reads.fq
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _cmd_index(args) -> int:
    from .index.build import build_fm_index
    from .index.files import Genome, GenomeIndex, save_index
    from .utils.config import IndexConfig
    from .utils.fasta import read_fasta
    from .utils.log import StopWatch

    cfg = IndexConfig.from_args(args)
    sw = StopWatch()
    contigs = read_fasta(cfg.genome)
    genome = Genome.from_contigs(contigs)
    sw.lap(f"loaded {len(contigs)} contig(s), {genome.n} bp")

    def sa_for(codes):
        if cfg.builder == "numpy":
            from .index.sais import suffix_array

            return suffix_array(codes)
        if cfg.builder == "native":
            from .index.native import suffix_array_native

            return suffix_array_native(codes)
        if cfg.builder == "device":
            from .index.device_build import suffix_array_device

            return suffix_array_device(codes)
        return None  # auto: build_fm_index picks native-else-numpy

    fwd = build_fm_index(
        genome.codes,
        sample_rate=cfg.sample_rate,
        sa=sa_for(genome.codes),
        keep_full_sa=cfg.full_sa,
    )
    rcodes = genome.codes[::-1].copy()
    rev = build_fm_index(rcodes, sample_rate=cfg.sample_rate, sa=sa_for(rcodes))
    gi = GenomeIndex(genome, fwd, rev)
    sw.lap(f"built forward+reverse FM indexes (builder={cfg.builder})")
    save_index(cfg.out, gi)
    sw.lap(f"saved {cfg.out}")
    if cfg.kmer:
        import numpy as _np

        from .index.kmer import build_kmer_table

        lo, hi = build_kmer_table(fwd, cfg.kmer)
        _np.savez(cfg.out + f".kmer{cfg.kmer}.npz", lo=lo, hi=hi)
        sw.lap(f"built {cfg.kmer}-mer table -> {cfg.out}.kmer{cfg.kmer}.npz")
    if cfg.seed:
        from .index.seedtable import build_seed_table, save_seed_table

        offsets, positions = build_seed_table(genome.codes, cfg.seed)
        save_seed_table(cfg.out + f".seed{cfg.seed}.npz", offsets, positions, cfg.seed)
        sw.lap(f"built {cfg.seed}-mer seed table -> {cfg.out}.seed{cfg.seed}.npz")
    return 0


def _cmd_align(args) -> int:
    import json

    from .index.files import load_index
    from .models.pipeline import ExactAligner, SuffixFilterAligner
    from .utils.config import AlignConfig
    from .utils.fasta import iter_reads
    from .utils.log import StopWatch, profile_to
    from .utils.sam import write_sam

    cfg = AlignConfig.from_args(args)
    sw = StopWatch()
    gi = load_index(cfg.index)
    sw.lap(f"loaded index ({gi.genome.n} bp)")

    kmer_kwargs = {}
    if cfg.kmer_table:
        import numpy as _np

        z = _np.load(cfg.kmer_table)
        j = int(_np.log2(z["lo"].size) / 2)
        kmer_kwargs = dict(kmer_table=(z["lo"], z["hi"]), kmer_j=j)
        sw.lap(f"loaded {j}-mer table")
    if cfg.seed_table:
        from .index.seedtable import load_seed_table

        offsets, positions, sj = load_seed_table(cfg.seed_table)
        kmer_kwargs.update(seed_table=(offsets, positions), seed_j=sj)
        sw.lap(f"loaded {sj}-mer seed table")

    mode = cfg.mode
    if mode == "auto":
        mode = "exact" if cfg.k == 0 else "pigeonhole"
    if mode == "long":
        return _align_long_reads(args, cfg, gi, kmer_kwargs, sw)
    if cfg.n_interval > 1:
        from .parallel.sharded_pipeline import ShardedAligner

        aligner = ShardedAligner(
            gi,
            k=cfg.k,
            n_interval=cfg.n_interval,
            seed_table=kmer_kwargs.get("seed_table"),
            seed_j=kmer_kwargs.get("seed_j", 0),
        )
    elif mode == "exact":
        aligner = ExactAligner(gi)
    elif mode == "onemm":
        from .models.one_mismatch import OneMismatchAligner

        aligner = OneMismatchAligner(gi)
    else:
        aligner = SuffixFilterAligner(
            gi,
            k=cfg.k,
            max_hits_per_piece=cfg.max_hits_per_piece,
            use_staircase=(mode == "staircase"),
            **kmer_kwargs,
        )

    # array streaming: uniform unpaired FASTQ goes straight to (B, L) arrays
    # (object batches cost more host time than the device step)
    base = cfg.reads[:-3] if cfg.reads.endswith(".gz") else cfg.reads
    if (
        base.endswith((".fq", ".fastq"))
        and not args.interleaved
        and not args.paired
        and cfg.mode in ("auto", "pigeonhole")
        and cfg.k > 0
        and cfg.n_interval == 1
    ):
        return _align_array_stream(args, gi, aligner, sw)

    reads = list(iter_reads(cfg.reads))
    paired = None
    if args.interleaved:
        assert len(reads) % 2 == 0, "interleaved input needs an even read count"
        mates = reads[1::2]
        reads = reads[0::2]
        from .models.paired import PairedAligner

        paired = PairedAligner(aligner)
        sw.lap(f"loaded {len(reads)} interleaved pairs")
    elif args.paired:
        mates = list(iter_reads(args.paired))
        assert len(mates) == len(reads), "paired files must have equal read counts"
        from .models.paired import PairedAligner

        paired = PairedAligner(aligner)
        sw.lap(f"loaded {len(reads)} pairs")
    else:
        sw.lap(f"loaded {len(reads)} reads")

    # resume: skip batches recorded as complete for this output path
    progress_path = (cfg.out + ".progress") if cfg.out != "-" else None
    start_batch = 0
    if args.resume and progress_path and os.path.exists(progress_path):
        start_batch = json.loads(open(progress_path).read()).get("batches_done", 0)
        sw.lap(f"resuming at batch {start_batch}")

    records = []
    n_mapped = n_proper = 0
    t0 = time.time()
    bs = cfg.batch_size
    n_batches = (len(reads) + bs - 1) // bs
    with profile_to(args.profile):
        for b in range(start_batch, n_batches):
            i = b * bs
            if paired is not None:
                batch = list(zip(reads[i : i + bs], mates[i : i + bs]))
                hits = paired.align_pairs(batch)
                records.extend(paired.to_sam(batch, hits))
                n_mapped += sum(
                    (ph.h1 is not None) + (ph.h2 is not None) for ph in hits
                )
                n_proper += sum(ph.proper for ph in hits)
            else:
                batch = reads[i : i + bs]
                if hasattr(aligner, "align_batch_submit"):
                    # pipelined: overlap host assembly with device compute
                    if not hasattr(aligner, "_pending"):
                        aligner._pending = (batch, aligner.align_batch_submit(batch))
                        continue
                    pbatch, ph = aligner._pending
                    aligner._pending = (batch, aligner.align_batch_submit(batch))
                    hits = aligner.align_batch_finish(ph)
                    batch = pbatch
                else:
                    hits = aligner.align_batch(batch)
                records.extend(aligner.to_sam(batch, hits))
                n_mapped += sum(h is not None for h in hits)
            if progress_path:
                with open(progress_path, "w") as fh:
                    fh.write(json.dumps({"batches_done": b + 1}))
    if not paired and hasattr(aligner, "_pending"):
        pbatch, ph = aligner._pending
        del aligner._pending
        hits = aligner.align_batch_finish(ph)
        records.extend(aligner.to_sam(pbatch, hits))
        n_mapped += sum(h is not None for h in hits)
    dt = time.time() - t0
    total = len(reads) * (2 if paired else 1)
    sw.lap(
        f"aligned: {n_mapped}/{total} mapped, {total/max(dt,1e-9):.0f} reads/s"
        + (f", {n_proper} proper pairs" if paired else "")
    )

    hdr = aligner.sam_header()
    if cfg.out == "-":
        sys.stdout.write(hdr + "\n")
        for r in records:
            sys.stdout.write(r.line() + "\n")
    else:
        write_sam(cfg.out, hdr, records)
        sw.lap(f"wrote {cfg.out}")
    if args.report:
        report = {
            "reads": total,
            "mapped": n_mapped,
            "proper_pairs": n_proper if paired else None,
            "reads_per_s": round(total / max(dt, 1e-9), 1),
            "wall_s": round(dt, 3),
            "mode": mode,
            "k": cfg.k,
            "batch_size": bs,
        }
        with open(args.report, "w") as fh:
            fh.write(json.dumps(report, indent=1))
        sw.lap(f"report -> {args.report}")
    return 0


def _align_long_reads(args, cfg, gi, kmer_kwargs, sw) -> int:
    """``--mode long``: chunked seeding + diagonal voting for reads past the
    short-read machines (models.long_read), then one whole-read banded
    affine traceback per mapped read for exact POS/CIGAR/AS/NM.  Records
    carry an ``XT:A:L`` tag marking the chunked long-read path."""
    import json

    from .models.long_read import LongReadAligner
    from .utils import sam
    from .utils.fasta import iter_reads

    if "seed_table" not in kmer_kwargs:
        sys.stderr.write("align --mode long requires --seed-table\n")
        return 2
    al = LongReadAligner(
        gi, kmer_kwargs["seed_table"], kmer_kwargs["seed_j"]
    )
    reads = list(iter_reads(cfg.reads))
    sw.lap(f"loaded {len(reads)} long reads")
    t0 = time.time()
    records = []
    n_mapped = 0
    bs = max(8, cfg.batch_size)
    for i in range(0, len(reads), bs):
        batch = reads[i : i + bs]
        L = max(len(r) for r in batch)
        arr = np.zeros((len(batch), L), dtype=np.int8)
        lens = np.empty(len(batch), dtype=np.int32)
        for t, r in enumerate(batch):
            arr[t, : len(r)] = r.codes
            lens[t] = len(r)
        lh = al.align_arrays(arr, lens)
        for t, r in enumerate(batch):
            if not lh.mapped[t]:
                records.append(sam.unmapped(r.name, r.codes, r.qual))
                continue
            n_mapped += 1
            ci, local = gi.genome.coord(int(lh.pos[t]))
            score, nm = lh.aux.get(t, (None, int(lh.dist[t])))
            rec = sam.mapped(
                r.name,
                r.codes,
                gi.genome.names[int(ci[0])],
                int(local[0]),
                int(lh.strand[t]),
                lh.cigars.get(t, f"{len(r)}M"),
                edit_distance=nm,
                mapq=37,
                qual=r.qual,
                score=score,
            )
            rec.tags = rec.tags + (("XT", "A", "L"),)
            records.append(rec)
    dt = time.time() - t0
    sw.lap(f"long-read mapped {n_mapped}/{len(reads)}, {len(reads)/max(dt,1e-9):.0f} reads/s")
    hdr = sam.header(gi.genome.names, gi.genome.lengths)
    if cfg.out == "-":
        sys.stdout.write(hdr + "\n")
        for r in records:
            sys.stdout.write(r.line() + "\n")
    else:
        sam.write_sam(cfg.out, hdr, records)
        sw.lap(f"wrote {cfg.out}")
    if args.report:
        with open(args.report, "w") as fh:
            fh.write(json.dumps({
                "reads": len(reads), "mapped": n_mapped,
                "reads_per_s": round(len(reads) / max(dt, 1e-9), 1),
                "wall_s": round(dt, 3), "mode": "long", "k": None,
                "batch_size": bs,
            }, indent=1))
        sw.lap(f"report -> {args.report}")
    return 0


def _align_array_stream(args, gi, aligner, sw) -> int:
    """Array-native align loop: FASTQ -> (B, L) code batches -> ArrayHits.

    Two-phase (submit N+1 before finish N) so host parsing/SAM assembly
    overlaps device compute; per-read objects are only materialised for
    SAM emission."""
    import json

    from .utils.fasta import iter_fastq_array_batches
    from .utils.log import profile_to

    progress_path = (args.out + ".progress") if args.out != "-" else None
    start_batch = 0
    if args.resume and progress_path and os.path.exists(progress_path):
        start_batch = json.loads(open(progress_path).read()).get("batches_done", 0)
        sw.lap(f"resuming at batch {start_batch}")

    # bounded memory end-to-end (ADVICE r1): parse batch_size reads at a
    # time, keep at most two batches in flight (submit N+1 before finish N
    # so host parsing/SAM assembly overlaps device compute), emit SAM
    # incrementally
    bs = args.batch_size
    batches = iter_fastq_array_batches(args.reads, bs)
    total = 0
    n_mapped = 0
    t0 = time.time()

    out_fh = sys.stdout if args.out == "-" else open(args.out, "w")
    out_fh.write(aligner.sam_header() + "\n")

    def emit(pb, ah, names, codes, quals, lengths):
        nonlocal n_mapped
        n_mapped += int(ah.mapped.sum())
        # column-wise emission straight from ArrayHits: no per-read
        # Read/SamRecord objects on the streaming fast path
        lines = aligner.to_sam_lines(names, codes, lengths, ah, quals=quals)
        out_fh.write("\n".join(lines) + "\n")
        if progress_path:
            with open(progress_path, "w") as fh:
                fh.write(json.dumps({"batches_done": pb + 1}))

    with profile_to(args.profile):
        pending = None
        for b, (names, codes, quals, lengths) in enumerate(batches):
            total += len(names)
            if b < start_batch:
                continue
            nxt = (
                b,
                aligner.align_arrays_submit(codes.astype(np.int8), lengths),
                names, codes, quals, lengths,
            )
            if pending is None:
                pending = nxt
                continue
            pb, ph, pn, pc, pq, pl = pending
            pending = nxt
            emit(pb, aligner.align_arrays_finish(ph), pn, pc, pq, pl)
        if pending is not None:
            pb, ph, pn, pc, pq, pl = pending
            emit(pb, aligner.align_arrays_finish(ph), pn, pc, pq, pl)
    dt = time.time() - t0
    sw.lap(f"aligned: {n_mapped}/{total} mapped, {total/max(dt,1e-9):.0f} reads/s")
    if args.out != "-":
        out_fh.close()
        sw.lap(f"wrote {args.out}")
    if args.report:
        report = {
            "reads": total,
            "mapped": n_mapped,
            "proper_pairs": None,
            "reads_per_s": round(total / max(dt, 1e-9), 1),
            "wall_s": round(dt, 3),
            "mode": "pigeonhole",
            "k": args.k,
            "batch_size": bs,
        }
        with open(args.report, "w") as fh:
            fh.write(json.dumps(report, indent=1))
        sw.lap(f"report -> {args.report}")
    return 0


def _cmd_simulate(args) -> int:
    from .index.files import Genome
    from .utils.fasta import read_fasta, write_fastq
    from .utils.simulate import simulate_reads

    genome = Genome.from_contigs(read_fasta(args.genome))
    sims = simulate_reads(
        genome.codes,
        n_reads=args.n,
        read_len=args.length,
        seed=args.seed,
        sub_rate=args.sub_rate,
        max_subs=args.max_subs,
        indel_rate=args.indel_rate,
        max_indels=args.max_indels,
    )
    write_fastq(args.out, [s.read for s in sims])
    print(f"wrote {len(sims)} reads to {args.out}")
    return 0


def _cmd_dump(args) -> int:
    from .index.files import load_index

    gi = load_index(args.index)
    print(f"n={gi.fwd.n} primary={gi.fwd.primary} sample_rate={gi.fwd.sample_rate}")
    print(f"contigs: {list(zip(gi.genome.names, gi.genome.lengths))}")
    print(f"counts A/C/G/T: {gi.fwd.counts.tolist()}  C[]: {gi.fwd.C.tolist()}")
    nbytes = sum(
        a.nbytes
        for a in (gi.fwd.bwt_words, gi.fwd.occ_cp, gi.fwd.ssa_values, gi.fwd.text_words)
    )
    print(f"fwd index tables ~{nbytes/1e6:.1f} MB host-side")
    return 0


def main(argv=None) -> int:
    # argparse defaults come FROM the config dataclasses (utils.config is
    # the single source of truth; hard-coded duplicates drifted once)
    from .utils.config import AlignConfig, IndexConfig

    icfg, acfg = IndexConfig(), AlignConfig()
    p = argparse.ArgumentParser(prog="gwa", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pi = sub.add_parser("index", help="build FM index from FASTA (reference: BWTransform)")
    pi.add_argument("genome")
    pi.add_argument("-o", "--out", required=True)
    pi.add_argument("--sample-rate", type=int, default=icfg.sample_rate)
    pi.add_argument(
        "--builder", choices=["auto", "numpy", "native", "device"], default=icfg.builder
    )
    pi.add_argument("--kmer", type=int, default=icfg.kmer, help="also build a j-mer table")
    pi.add_argument(
        "--full-sa", action="store_true",
        help="keep the full suffix array in the index (locate = one gather)",
    )
    pi.add_argument(
        "--seed", type=int, default=icfg.seed,
        help="also build a CSR j-mer seed table (index.seedtable)",
    )
    pi.set_defaults(fn=_cmd_index)

    pa = sub.add_parser("align", help="align reads to an index")
    pa.add_argument("index")
    pa.add_argument("reads")
    pa.add_argument("-o", "--out", default=acfg.out)
    pa.add_argument("-k", type=int, default=acfg.k, help="max edit distance")
    pa.add_argument(
        "--mode",
        choices=["auto", "exact", "onemm", "pigeonhole", "staircase", "long"],
        default=acfg.mode,
    )
    pa.add_argument("--batch-size", type=int, default=acfg.batch_size)
    pa.add_argument("--max-hits-per-piece", type=int, default=acfg.max_hits_per_piece)
    pa.add_argument("--paired", help="R2 file: align as pairs (reads = R1)")
    pa.add_argument(
        "--interleaved", action="store_true",
        help="reads file holds R1/R2 alternating (paired mode)",
    )
    pa.add_argument("--kmer-table", help=".npz with lo/hi arrays (index.kmer)")
    pa.add_argument("--seed-table", help=".npz seed table (index.seedtable)")
    pa.add_argument("--report", help="write a JSON run report here")
    pa.add_argument("--resume", action="store_true", help="resume from .progress")
    pa.add_argument("--profile", help="capture a jax.profiler trace to this dir")
    pa.add_argument(
        "--n-interval",
        type=int,
        default=acfg.n_interval,
        help="interval-shard the index across this many devices (config 5)",
    )
    pa.set_defaults(fn=_cmd_align)

    ps = sub.add_parser("simulate", help="simulate reads from a genome")
    ps.add_argument("genome")
    ps.add_argument("-o", "--out", required=True)
    ps.add_argument("-n", type=int, default=1000)
    ps.add_argument("-l", "--length", type=int, default=100)
    ps.add_argument("--seed", type=int, default=1)
    ps.add_argument("--sub-rate", type=float, default=0.0)
    ps.add_argument("--max-subs", type=int, default=None)
    ps.add_argument("--indel-rate", type=float, default=0.0)
    ps.add_argument("--max-indels", type=int, default=0)
    ps.set_defaults(fn=_cmd_simulate)

    pd = sub.add_parser("dump", help="print index metadata")
    pd.add_argument("index")
    pd.set_defaults(fn=_cmd_dump)

    args = p.parse_args(argv)
    from .utils import compile_cache

    compile_cache.enable()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
