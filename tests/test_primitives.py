"""Oracle tests for packed sequences and bit vectors (SURVEY.md §2 #1–#3)."""

import numpy as np
import pytest

from genome_weaver_align.utils import dna, packing
from genome_weaver_align.utils.bitvector import BitVector


def test_encode_decode_roundtrip():
    s = "ACGTacgtNRYacgt"
    codes = dna.encode(s)
    assert codes.tolist() == [0, 1, 2, 3, 0, 1, 2, 3, 4, 4, 4, 0, 1, 2, 3]
    assert dna.decode(codes[:8]) == "ACGTACGT"


def test_revcomp():
    codes = dna.encode("AACGT")
    assert dna.decode(dna.revcomp(codes)) == "ACGTT"
    # revcomp is an involution
    assert np.array_equal(dna.revcomp(dna.revcomp(codes)), codes)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 100, 1000])
def test_pack_unpack_roundtrip(n):
    rng = np.random.default_rng(n)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    words = packing.pack(codes)
    assert np.array_equal(packing.unpack(words, n), codes)
    if n:
        idx = rng.integers(0, n, size=min(n, 64))
        assert np.array_equal(packing.get(words, idx), codes[idx])


@pytest.mark.parametrize("n", [1, 16, 129, 1000])
def test_count_prefix_vs_naive(n):
    rng = np.random.default_rng(n + 7)
    codes = rng.integers(0, 4, size=n, dtype=np.uint8)
    words = packing.pack(codes)
    for c in range(4):
        for k in [0, 1, n // 2, n - 1, n]:
            assert packing.count_prefix(words, c, k) == int((codes[:k] == c).sum())


def test_popcount32():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    expect = np.array([bin(int(v)).count("1") for v in x])
    assert np.array_equal(packing.popcount32(x), expect)


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 127, 128, 129, 1000])
def test_bitvector_rank(n):
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 2, size=n).astype(bool)
    bv = BitVector(bits)
    ks = np.arange(n + 1)
    expect = np.concatenate([[0], np.cumsum(bits)]) if n else np.zeros(1, int)
    assert np.array_equal(bv.rank1(ks), expect)
    assert np.array_equal(bv.rank0(ks), ks - expect)
    if n:
        idx = np.arange(n)
        assert np.array_equal(bv.get(idx), bits)


def test_fastq_array_batches_roundtrip(tmp_path):
    """Chunked vectorised FASTQ parse == per-read parse, uniform and ragged
    lengths, across chunk boundaries (ADVICE r1: bounded-memory array path)."""
    from genome_weaver_align.utils import dna
    from genome_weaver_align.utils.fasta import (
        Read,
        iter_fastq_array_batches,
        read_fastq_arrays,
        write_fastq,
    )

    rng = np.random.default_rng(9)
    for tag, lens in (("uniform", [50] * 23), ("ragged", [30, 50, 41, 50, 7] * 5)):
        reads = [
            Read(
                f"r{i}",
                rng.integers(0, 5, size=l).astype(np.uint8),
                rng.integers(0, 40, size=l).astype(np.int32),
            )
            for i, l in enumerate(lens)
        ]
        path = tmp_path / f"{tag}.fq"
        write_fastq(path, reads)

        # chunked iterator: 7 reads/batch exercises a ragged final chunk
        seen = 0
        for names, codes, quals, lengths in iter_fastq_array_batches(path, 7):
            assert len(names) <= 7
            for j in range(len(names)):
                i = seen + j
                l = int(lengths[j])
                assert names[j] == f"r{i}"
                assert l == lens[i]
                assert np.array_equal(codes[j, :l], reads[i].codes)
                assert np.array_equal(quals[j, :l], reads[i].qual)
            seen += len(names)
        assert seen == len(reads)

        # whole-file wrapper stitches multiple chunks (batch_size=7 forces it)
        names, codes, quals, lengths = read_fastq_arrays(path, batch_size=7)
        assert names == [r.name for r in reads]
        for i, r in enumerate(reads):
            l = int(lengths[i])
            assert np.array_equal(codes[i, :l], r.codes)
            assert np.array_equal(quals[i, :l], r.qual)
