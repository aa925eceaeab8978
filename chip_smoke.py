#!/usr/bin/env python3
"""Smoke run of the aligner's main path on an NVIDIA GPU.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards: the interval-sharded path only

One card, in one process, through the same entry points a user calls:

1. device  — the card as JAX and ``nvidia-smi`` report it;
2. index   — a chr20-scale genome (64,444,167 bp, seeded, with a tandem
             repeat block) indexed by ``gwa index --builder native --seed 13``;
3. align   — 131,072 simulated 100 bp reads (<= 2 substitutions) aligned by
             ``gwa align -k 2`` in 64k batches, twice: the second run must
             compile nothing; the SAM is checked against the simulated truth
             and 1,024 records against the host edit-distance oracle; the
             second run's CLI wall time is printed beside the fused step's;
4. verify  — the GPU verify engine against ``ops.dp.banded_edit_distance``
             (jnp under XLA) at the pipeline's widths, bit for bit, and
             against the host oracle ``ops.dp.banded_rows_host``;
5. gpu     — the checks behind every test marked ``gpu``.

``--four`` aligns the same stream with ``gwa align --n-interval 4`` (mesh
1x4) and ``--n-interval 2`` (2x2) and requires SAM byte-identical to the
one-card run in the same process.

Every phase prints one line; the last line is one JSON object.  Without a
GPU, or when any check fails, the script exits non-zero and prints no
result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
GENOME_LEN = 64_444_167  # human chr20 scale: BASELINE config 3
N_READS = 131_072
BATCH = 65_536
READ_LEN = 100
SEED_J = 13
SLACK = 6  # compacted verify lanes per read (models.pipeline verify_slack)
ORACLE_READS = 1_024
ORACLE_LANES = 4_096
# (L, k): config 3 (100 bp, k=2, band 9) and config 4 (150 bp, k=4, band 17)
VERIFY_CASES = ((100, 2), (150, 4))
# the checks behind tests/test_dp_pallas.py::test_engine_on_gpu
GPU_CASES = (
    dict(n=4_096, L=100, k=2, seed=1),
    dict(n=2_000, L=150, k=4, seed=2),
    dict(n=1_000, L=50, k=1, W=30, seed=3),  # narrow windows: dead lanes
)

CARD = ""  # "<name>, <power limit>" of the card, set by device_phase


def say(phase: str, **fields):
    """One phase line; every number is printed beside the card it ran on."""
    print(f"{phase}: " + json.dumps(dict(fields, card=CARD)), flush=True)


def device_phase(count: int) -> dict:
    from genome_weaver_align.utils.device import gpu_record

    rec = gpu_record()
    if rec["count"] < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX sees {rec['count']}")
    global CARD
    CARD = rec.pop("card")
    print(f"card: {CARD}", flush=True)
    say("device", kind=rec["kind"], count=rec["count"])
    return rec


# ------------------------------------------------------------------ data

def make_genome(n: int, seed: int) -> np.ndarray:
    """Uniform random codes with a tandem block (a 300 bp unit tiled 30x)."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, size=300, dtype=np.uint8)
    rep = np.tile(unit, 30)[: n // 2]
    return np.concatenate([rep, rng.integers(0, 4, size=n - rep.size, dtype=np.uint8)])


def index_phase(work: Path, n: int, seed: int = 5) -> dict:
    """Genome FASTA -> ``gwa index`` (native SA-IS, j=13 seed table)."""
    from genome_weaver_align import cli
    from genome_weaver_align.utils.fasta import Contig, write_fasta

    t0 = time.time()
    codes = make_genome(n, seed)
    fa, idx = work / "g.fa", work / "g.npz"
    write_fasta(fa, [Contig("chrS", codes)])
    rc = cli.main([
        "index", str(fa), "-o", str(idx), "--builder", "native",
        "--sample-rate", "8", "--seed", str(SEED_J),
    ])
    if rc != 0:
        raise RuntimeError(f"gwa index exited {rc}")
    setup = time.time() - t0
    say("index", genome_bp=n, setup_s=setup)
    return {"fa": fa, "idx": idx, "seed": Path(f"{idx}.seed{SEED_J}.npz"), "codes": codes}


def simulate(work: Path, fa: Path, n_reads: int, seed: int = 7) -> Path:
    from genome_weaver_align import cli

    fq = work / "r.fq"
    rc = cli.main([
        "simulate", str(fa), "-o", str(fq), "-n", str(n_reads), "-l", str(READ_LEN),
        "--sub-rate", "0.02", "--max-subs", "2", "--seed", str(seed),
    ])
    if rc != 0:
        raise RuntimeError(f"gwa simulate exited {rc}")
    return fq


# ------------------------------------------------------------------ align

@contextlib.contextmanager
def count_compiles():
    """Backend compilations (and their seconds) inside the block."""
    from jax import monitoring
    from jax._src import dispatch

    seen = {"n": 0, "s": 0.0}

    def listener(event, duration, **_):
        if event == dispatch.BACKEND_COMPILE_EVENT:
            seen["n"] += 1
            seen["s"] += duration

    monitoring.register_event_duration_secs_listener(listener)
    try:
        yield seen
    finally:
        monitoring.unregister_event_duration_listener(listener)


@contextlib.contextmanager
def record_fused_step():
    """Keep the arguments of the last fused align step the CLI ran."""
    from genome_weaver_align.models import pipeline

    last = {}
    orig = pipeline.fused_align_step

    def recording(*args, **static):
        last["call"] = (args, static)
        return orig(*args, **static)

    pipeline.fused_align_step = recording
    try:
        yield last
    finally:
        pipeline.fused_align_step = orig


def parse_sam(path: Path) -> list[list[str]]:
    with open(path) as fh:
        return [ln.rstrip("\n").split("\t") for ln in fh if not ln.startswith("@")]


def check_truth(records, n_reads: int) -> tuple[float, float]:
    """(mapped, correct) fractions; names carry r<i>_p<pos>_s<strand>_..."""
    if len(records) != n_reads:
        raise AssertionError(f"{len(records)} SAM records for {n_reads} reads")
    mapped = correct = 0
    for f in records:
        flag = int(f[1])
        if flag & 4:
            continue
        mapped += 1
        parts = f[0].split("_")
        pos, strand = int(parts[1][1:]), int(parts[2][1:])
        correct += int(f[3]) - 1 == pos and bool(flag & 16) == bool(strand)
    return mapped / n_reads, correct / n_reads


def check_oracle(records, codes: np.ndarray, k: int, n: int) -> int:
    """Host full-matrix distance == NM on the first ``n`` all-M records."""
    from genome_weaver_align.ops import dp
    from genome_weaver_align.utils import dna

    done = 0
    for f in records:
        if int(f[1]) & 4 or f[5] != f"{len(f[9])}M":
            continue
        read = dna.encode(f[9])
        p = int(f[3]) - 1
        win = codes[max(0, p - k): p + read.size + k]
        nm = int(next(t for t in f[11:] if t.startswith("NM:i:"))[5:])
        got = dp.edit_distance_semiglobal_host(read, win)
        if got != nm:
            raise AssertionError(f"{f[0]}: host oracle {got} != NM {nm}")
        done += 1
        if done == n:
            return done
    raise AssertionError(f"only {done} all-M mapped records to re-check")


def time_call(fn, args, reps: int = 5) -> float:
    """Median seconds of ``fn(*args)`` ending in block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def align_phase(work: Path, ix: dict, n_reads: int, batch: int, k: int = 2,
                min_frac: float = 0.999, oracle_reads: int = ORACLE_READS) -> dict:
    from genome_weaver_align import cli
    from genome_weaver_align.models import pipeline

    fq = simulate(work, ix["fa"], n_reads)
    sam, rep = work / "out.sam", work / "rep.json"
    argv = [
        "align", str(ix["idx"]), str(fq), "-k", str(k), "--seed-table", str(ix["seed"]),
        "--batch-size", str(batch), "--report", str(rep), "-o", str(sam),
    ]
    with record_fused_step() as last:
        with count_compiles() as warm:
            if cli.main(argv) != 0:
                raise RuntimeError("gwa align (warm-up) failed")
        with count_compiles() as steady:
            if cli.main(argv) != 0:
                raise RuntimeError("gwa align failed")
    if steady["n"]:
        raise AssertionError(f"{steady['n']} compilations inside the steady run")
    report = json.loads(rep.read_text())
    records = parse_sam(sam)
    mapped, correct = check_truth(records, n_reads)
    if report["mapped"] / report["reads"] != mapped:
        raise AssertionError(f"report mapped {report['mapped']} != SAM {mapped}")
    if mapped < min_frac or correct < min_frac:
        raise AssertionError(f"mapped {mapped} correct {correct} below {min_frac}")
    rechecked = check_oracle(records, ix["codes"], k, oracle_reads)

    args, static = last["call"]
    key = tuple(sorted(static.items())) + (args[2] is not None, args[3] is not None)
    step = pipeline._fused_cache[key]
    mem = step.lower(*args).compile().memory_analysis()
    # the second run's whole CLI loop; with two batches in a two-deep
    # submit/finish pipeline this is no steady-state batch time
    say(
        "align",
        reads=n_reads, batch=batch, mapped=mapped, correct=correct,
        oracle_rechecked=rechecked, batches=-(-n_reads // batch),
        cli_wall_s=report["wall_s"], cli_reads_per_s=report["reads_per_s"],
        fused_step_s=time_call(step, args),
        compile_s=warm["s"], compiles_warm=warm["n"], compiles_steady=steady["n"],
        step_temp_bytes=mem.temp_size_in_bytes,
        step_argument_bytes=mem.argument_size_in_bytes,
        step_output_bytes=mem.output_size_in_bytes,
    )
    return {"fq": fq, "sam": sam}


# ------------------------------------------------------------------ verify

def verify_inputs(n: int, L: int, k: int, seed: int, W: int | None = None):
    """(reads, lengths, windows) int8/int32 host arrays at verify widths.

    Half the lanes hold a planted copy of their read with up to k
    substitutions; lengths vary down to L // 2; 0.2% of codes are N (4)."""
    rng = np.random.default_rng(seed)
    W = L + 3 * k if W is None else W
    reads = rng.integers(0, 4, size=(n, L), dtype=np.int8)
    wins = rng.integers(0, 4, size=(n, W), dtype=np.int8)
    lengths = np.where(
        rng.random(n) < 0.8, L, rng.integers(L // 2, L + 1, size=n)
    ).astype(np.int32)
    plant = np.nonzero(rng.random(n) < 0.5)[0]
    span = min(L, W - k)
    if span > 0:
        wins[plant, k:k + span] = reads[plant, :span]
        n_sub = rng.integers(0, k + 1, size=plant.size)
        for t in range(k):
            rows = plant[n_sub > t]
            at = k + rng.integers(0, span, size=rows.size)
            wins[rows, at] = (wins[rows, at] + 1) % 4
    reads[rng.random((n, L)) < 0.002] = 4
    wins[rng.random((n, W)) < 0.002] = 4
    return reads, lengths, wins


def check_engine(n: int, L: int, k: int, seed: int, W: int | None = None,
                 interpret: bool = False) -> int:
    """The verify engine vs the jnp reference on ``verify_inputs``; returns
    the number of lanes within k."""
    import jax.numpy as jnp

    arrays = (jnp.asarray(a) for a in verify_inputs(n, L, k, seed, W))
    return int((engine_vs_reference(*arrays, k, interpret) <= k).sum())


def engine_vs_reference(reads, lengths, wins, k: int, interpret: bool = False):
    """Raise unless the engine matches ``ops.dp.banded_edit_distance`` bit
    for bit in dist and end_b on every lane; returns the reference dist.

    ``interpret`` runs the Pallas kernel in interpret mode (the CPU tests);
    otherwise the platform's engine runs as the pipeline calls it."""
    from genome_weaver_align.ops import dp, dp_pallas

    want = dp.banded_edit_distance(reads, lengths, wins, k)
    if interpret:
        got = dp_pallas.banded_edit_distance_pallas(reads, lengths, wins, k, interpret=True)
    else:
        got = dp.banded_edit_distance_best(reads, lengths, wins, k)
    L = reads.shape[1]
    for name, g, w in zip(("dist", "end_b"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        if not np.array_equal(g, w):
            bad = np.nonzero(g != w)[0]
            raise AssertionError(
                f"{name} differs on {bad.size}/{g.size} lanes (L={L} k={k}), "
                f"first lane {bad[0]}: {g[bad[0]]} != {w[bad[0]]}"
            )
    return np.asarray(want[0])


def host_oracle_dist(reads, lengths, wins, k: int) -> np.ndarray:
    from genome_weaver_align.ops import dp

    D = dp.banded_rows_host(reads, lengths, wins, k)
    boff = np.arange(4 * k + 1) - k
    j_end = lengths[:, None] + boff[None, :]
    Df = np.where(
        (j_end >= 0) & (j_end <= wins.shape[1]),
        D[np.arange(len(lengths)), lengths, :], dp._HINF,
    )
    return np.minimum(Df.min(axis=1), dp._HINF)


def timed_loop(fn, reads, lengths, wins, iters: int) -> float:
    """Seconds per call of ``fn`` inside one jitted loop.

    Each iteration rewrites the first code of the reads and of the windows
    from the loop counter and the previous result, so neither the call
    nor any layout work it does on its inputs (the kernel's transposes)
    can be hoisted out of the loop.  The rewrite is an elementwise select,
    which XLA fuses into the first consumer of each array."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    def first(a):
        return (lax.broadcasted_iota(jnp.int32, a.shape, 0) == 0) & (
            lax.broadcasted_iota(jnp.int32, a.shape, 1) == 0
        )

    @jax.jit
    def run(r, ln, w, n):
        def body(i, acc):
            code = ((i + acc) & 3).astype(r.dtype)
            d, _ = fn(jnp.where(first(r), code, r), ln, jnp.where(first(w), code, w))
            return acc + d[0]

        return lax.fori_loop(0, n, body, jnp.int32(0))

    jax.block_until_ready(run(reads, lengths, wins, 1))
    ts = {}
    for m in (iters, 4 * iters):
        t0 = time.perf_counter()
        jax.block_until_ready(run(reads, lengths, wins, m))
        ts[m] = time.perf_counter() - t0
    return (ts[4 * iters] - ts[iters]) / (3 * iters)


def verify_phase(lanes: int, iters: int = 10):
    import jax
    import jax.numpy as jnp

    from genome_weaver_align.ops import dp

    for L, k in VERIFY_CASES:
        h_reads, h_len, h_wins = verify_inputs(lanes, L, k, seed=L + k)
        reads, lengths, wins = jnp.asarray(h_reads), jnp.asarray(h_len), jnp.asarray(h_wins)
        want = engine_vs_reference(reads, lengths, wins, k)
        m = ORACLE_LANES
        host = host_oracle_dist(h_reads[:m], h_len[:m], h_wins[:m], k)
        if not np.array_equal(host, want[:m]):
            raise AssertionError(f"engine dist differs from the host oracle (L={L} k={k})")
        engine_s = timed_loop(
            lambda r, ln, w: dp.banded_edit_distance_best(r, ln, w, k),
            reads, lengths, wins, iters,
        )
        xla_s = timed_loop(
            lambda r, ln, w: dp.banded_edit_distance(r, ln, w, k),
            reads, lengths, wins, iters,
        )
        say(
            "verify", lanes=lanes, L=L, k=k, W=L + 3 * k,
            engine=dp.verify_engine(jax.default_backend()), lanes_within_k=int((want <= k).sum()),
            oracle_lanes=m, engine_ms=engine_s * 1e3, xla_jnp_ms=xla_s * 1e3,
        )


def gpu_checks_phase():
    for case in GPU_CASES:
        check_engine(**case)
    say("gpu", checks=len(GPU_CASES))


# ------------------------------------------------------------------ four

def four_phase(work: Path, ix: dict, n_reads: int, batch: int, k: int = 2):
    """``gwa align --n-interval`` on four cards (meshes 1x4 and 2x2) against
    the same CLI run with the sharded aligner cut to one card (mesh 1x1).

    The SAM must be byte-identical.  The default one-card aligner (no
    ``--n-interval``) is compared too, and its differing lines counted
    without failing the run: its overflow fallback reruns at 16x the hit
    budget (then the staircase tier for reads still unmapped), where the
    sharded aligner reruns at 4x only, so a read still overflowed (XO:i:1)
    may get another repeat copy or X0 there."""
    import jax

    from genome_weaver_align import cli
    from genome_weaver_align.parallel import sharded_pipeline

    fq = simulate(work, ix["fa"], n_reads)
    base = ["align", str(ix["idx"]), str(fq), "-k", str(k), "--seed-table",
            str(ix["seed"]), "--batch-size", str(batch)]

    def run(tag: str, extra: list[str]) -> tuple[bytes, float]:
        out = work / f"{tag}.sam"
        t0 = time.time()
        if cli.main(base + extra + ["-o", str(out)]) != 0:
            raise RuntimeError(f"gwa align {' '.join(extra)} failed")
        return out.read_bytes(), time.time() - t0

    made, one_card = [], [False]
    orig = sharded_pipeline.ShardedAligner

    class Recorded(orig):
        def __init__(self, gi, **kw):
            if one_card[0]:
                kw.update(n_interval=1, devices=jax.devices()[:1])
            super().__init__(gi, **kw)
            made.append(self)

    sharded_pipeline.ShardedAligner = Recorded
    try:
        one_card[0] = True
        ref, ref_s = run("one", ["--n-interval", "4"])
        one_card[0] = False
        default, default_s = run("default", [])
        for n_int in (4, 2):
            got, dt = run(f"int{n_int}", ["--n-interval", str(n_int)])
            al = made[-1]
            spread = {
                name: sorted(d.id for d in arr.sharding.device_set)
                for name, arr in (
                    ("bwt_blocks", al.sh.bwt_blocks), ("text_words", al.tx.words),
                    ("seed_positions", al.sst.positions),
                )
            }
            say(
                "four", mesh=dict(al.mesh.shape), reads=n_reads,
                sam_identical=got == ref, sam_bytes=len(got),
                lines_differing_from_default=diff_lines(default, got),
                device_sets=spread, wall_s=dt, one_card_wall_s=ref_s,
                default_one_card_wall_s=default_s,
            )
            if got != ref:
                raise AssertionError(
                    f"--n-interval {n_int}: {diff_lines(ref, got)} SAM lines differ"
                )
            if any(len(v) != 4 for v in spread.values()):
                raise AssertionError(f"shards not spread over 4 cards: {spread}")
    finally:
        sharded_pipeline.ShardedAligner = orig


def diff_lines(a: bytes, b: bytes) -> int:
    la, lb = a.decode().splitlines(), b.decode().splitlines()
    return sum(x != y for x, y in zip(la, lb)) + abs(len(la) - len(lb))


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the interval-sharded path on four cards")
    args = ap.parse_args(argv)

    device = device_phase(4 if args.four else 1)
    from genome_weaver_align.utils import compile_cache

    compile_cache.enable()
    work = ROOT / "smoke_work"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    try:
        ix = index_phase(work, GENOME_LEN)
        if args.four:
            four_phase(work, ix, N_READS, BATCH)
        else:
            align_phase(work, ix, N_READS, BATCH)
            verify_phase(BATCH * SLACK)
            gpu_checks_phase()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
