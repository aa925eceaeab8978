"""CLI end-to-end: index -> simulate -> align -> SAM on disk."""

import numpy as np

from genome_weaver_align.cli import main
from genome_weaver_align.utils import dna
from genome_weaver_align.utils.fasta import Contig, write_fasta


def test_cli_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    fa = tmp_path / "g.fa"
    write_fasta(
        fa,
        [
            Contig("chr1", rng.integers(0, 4, size=9000, dtype=np.uint8)),
            Contig("chr2", rng.integers(0, 4, size=6000, dtype=np.uint8)),
        ],
    )
    idx = tmp_path / "g.npz"
    assert main(["index", str(fa), "-o", str(idx), "--sample-rate", "16"]) == 0

    reads = tmp_path / "r.fq"
    assert (
        main(
            [
                "simulate",
                str(fa),
                "-o",
                str(reads),
                "-n",
                "50",
                "-l",
                "80",
                "--sub-rate",
                "0.02",
                "--max-subs",
                "2",
            ]
        )
        == 0
    )

    out = tmp_path / "out.sam"
    assert main(["align", str(idx), str(reads), "-k", "2", "-o", str(out)]) == 0
    lines = out.read_text().splitlines()
    assert lines[0].startswith("@HD")
    sq = [l for l in lines if l.startswith("@SQ")]
    assert len(sq) == 2
    body = [l for l in lines if not l.startswith("@")]
    assert len(body) == 50
    mapped = [l for l in body if not (int(l.split("\t")[1]) & 0x4)]
    assert len(mapped) == 50

    assert main(["dump", str(idx)]) == 0


def test_cli_paired_and_report(tmp_path):
    import json

    rng = np.random.default_rng(7)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [Contig("c1", rng.integers(0, 4, size=20000, dtype=np.uint8))])
    idx = tmp_path / "g.npz"
    assert main(["index", str(fa), "-o", str(idx), "--sample-rate", "8"]) == 0

    # simulate pairs via the library (CLI simulate is single-end)
    from genome_weaver_align.index.files import load_index
    from genome_weaver_align.utils import simulate
    from genome_weaver_align.utils.fasta import write_fastq

    gi = load_index(idx)
    pairs = simulate.simulate_pairs(gi.genome.codes, 20, 80, seed=3)
    write_fastq(tmp_path / "r1.fq", [p.r1.read for p in pairs])
    write_fastq(tmp_path / "r2.fq", [p.r2.read for p in pairs])

    out = tmp_path / "out.sam"
    rep = tmp_path / "report.json"
    assert (
        main(
            [
                "align", str(idx), str(tmp_path / "r1.fq"),
                "--paired", str(tmp_path / "r2.fq"),
                "-k", "2", "-o", str(out), "--report", str(rep),
            ]
        )
        == 0
    )
    lines = [l for l in out.read_text().splitlines() if not l.startswith("@")]
    assert len(lines) == 40
    flags = [int(l.split("\t")[1]) for l in lines]
    assert all(f & 0x1 for f in flags)
    assert sum(1 for f in flags if f & 0x2) >= 36  # proper pairs
    r = json.loads(rep.read_text())
    assert r["mapped"] >= 38 and r["proper_pairs"] >= 18
    assert (tmp_path / "out.sam.progress").exists()


def test_cli_sharded_align(tmp_path):
    rng = np.random.default_rng(12)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [Contig("c1", rng.integers(0, 4, size=15000, dtype=np.uint8))])
    idx = tmp_path / "g.npz"
    assert main(["index", str(fa), "-o", str(idx)]) == 0
    reads = tmp_path / "r.fq"
    assert main([
        "simulate", str(fa), "-o", str(reads), "-n", "30", "-l", "80",
        "--sub-rate", "0.02", "--max-subs", "2",
    ]) == 0
    out1 = tmp_path / "single.sam"
    out2 = tmp_path / "sharded.sam"
    assert main(["align", str(idx), str(reads), "-k", "2", "-o", str(out1)]) == 0
    assert main([
        "align", str(idx), str(reads), "-k", "2", "-o", str(out2),
        "--n-interval", "4",
    ]) == 0
    # byte-identical output whatever the mesh (minus nothing: same header)
    assert out1.read_text() == out2.read_text()


def test_cli_interleaved(tmp_path):
    rng = np.random.default_rng(21)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [Contig("c1", rng.integers(0, 4, size=20000, dtype=np.uint8))])
    idx = tmp_path / "g.npz"
    assert main(["index", str(fa), "-o", str(idx)]) == 0
    from genome_weaver_align.index.files import load_index
    from genome_weaver_align.utils import simulate
    from genome_weaver_align.utils.fasta import write_fastq

    gi = load_index(idx)
    pairs = simulate.simulate_pairs(gi.genome.codes, 10, 80, seed=5)
    inter = []
    for p in pairs:
        inter += [p.r1.read, p.r2.read]
    write_fastq(tmp_path / "il.fq", inter)
    out = tmp_path / "o.sam"
    assert main(
        ["align", str(idx), str(tmp_path / "il.fq"), "--interleaved", "-k", "2", "-o", str(out)]
    ) == 0
    body = [l for l in out.read_text().splitlines() if not l.startswith("@")]
    assert len(body) == 20
    assert all(int(l.split("\t")[1]) & 0x1 for l in body)


def test_cli_long_read_mode(tmp_path):
    """--mode long: 1 kb reads map via chunked seeding; XT:A:L marks them."""
    rng = np.random.default_rng(8)
    codes = rng.integers(0, 4, size=300_000, dtype=np.uint8)
    fa = tmp_path / "g.fa"
    write_fasta(fa, [Contig("chrL", codes)])
    idx = tmp_path / "g.npz"
    assert main(["index", str(fa), "-o", str(idx), "--seed", "13"]) == 0

    # 1 kb reads with a few substitutions, written as FASTQ
    n, L = 6, 1024
    pos = rng.integers(0, codes.size - L, size=n)
    with open(tmp_path / "r.fq", "w") as fh:
        for i in range(n):
            seq = codes[pos[i] : pos[i] + L].copy()
            at = rng.integers(0, L, size=5)
            seq[at] = (seq[at] + rng.integers(1, 4, size=5)) % 4
            fh.write(f"@lr{i}\n{dna.decode(seq)}\n+\n{'I'*L}\n")

    out = tmp_path / "out.sam"
    assert main([
        "align", str(idx), str(tmp_path / "r.fq"), "--mode", "long",
        "--seed-table", str(idx) + ".seed13.npz", "-o", str(out),
    ]) == 0
    body = [l for l in out.read_text().splitlines() if not l.startswith("@")]
    assert len(body) == n
    for i, line in enumerate(body):
        f = line.split("\t")
        assert f[1] in ("0", "16") and "XT:A:L" in line
        assert abs(int(f[3]) - 1 - pos[i]) <= 24, (i, f[3], pos[i])
