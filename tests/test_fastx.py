import gzip

import numpy as np
import pytest

from fedrann_jax.io.fastx import read_fastx, reverse_complement
from fedrann_jax.io.packing import INVALID, encode_bases, pack_reads
from fedrann_jax.io.fastx import FastxRecord


def test_reverse_complement():
    assert reverse_complement("ACGT") == "ACGT"
    assert reverse_complement("AACCGGTT") == "AACCGGTT"[::-1].translate(
        str.maketrans("ACGT", "TGCA")
    )
    assert reverse_complement("ACGTN") == "NACGT"


def test_fasta_reader(tmp_path):
    p = tmp_path / "x.fasta"
    p.write_text(">r1 some description\nACGT\nACGT\n>r2\nTTTT\n")
    recs = list(read_fastx(str(p)))
    assert [r.name for r in recs] == ["r1", "r2"]
    assert recs[0].sequence == "ACGTACGT"
    assert recs[1].sequence == "TTTT"


def test_fastq_reader_gzipped(tmp_path):
    p = tmp_path / "x.fastq.gz"
    with gzip.open(p, "wt") as f:
        f.write("@r1\nACGTA\n+\nIIIII\n@r2\nGGGC\n+\nIIII\n")
    recs = list(read_fastx(str(p)))
    assert [r.name for r in recs] == ["r1", "r2"]
    assert recs[0].sequence == "ACGTA"
    assert recs[1].sequence == "GGGC"


def test_bad_format(tmp_path):
    p = tmp_path / "x.txt"
    p.write_text("hello\n")
    with pytest.raises(ValueError):
        list(read_fastx(str(p)))


def test_auto_length_buckets():
    from fedrann_jax.io.packing import auto_length_buckets

    # pow2 classes actually occupied, low-mass classes merged upward
    lengths = [900] * 50 + [1500] * 40 + [3000] * 9 + [250000] * 1
    ladder = auto_length_buckets(lengths, min_frac=0.02, floor=1024)
    assert ladder == (1024, 2048, 4096, 262144)
    # a low-mass class merges into the next one UP (never down: its reads
    # would not fit a smaller bucket), so a long-tail top class survives
    ladder = auto_length_buckets([1500] * 1 + [3000] * 99, min_frac=0.02)
    assert ladder == (4096,)
    ladder = auto_length_buckets([1000] * 99 + [1500] * 1, min_frac=0.02)
    assert ladder == (1024, 2048)
    # the cap clamps ultra-long reads (they chunk-split downstream)
    assert auto_length_buckets([10_000_000]) == (262144,)
    # ladder size bound: least-populated buckets merge upward first
    lengths = sum(([1 << b] * (b + 1) for b in range(10, 18)), [])
    ladder = auto_length_buckets(lengths, min_frac=0.0, max_buckets=3)
    assert len(ladder) == 3 and ladder[-1] == 1 << 17
    # empty input still yields a usable ladder
    assert auto_length_buckets([]) == (1024,)


def test_pack_reads_auto_buckets_roundtrip():
    from fedrann_jax.io.packing import auto_length_buckets

    recs = [FastxRecord(f"r{i}", "ACGT" * (200 + 37 * i)) for i in range(10)]
    packed = pack_reads(recs, length_buckets=None)
    expect = auto_length_buckets([len(r.sequence) for r in recs])
    assert tuple(sorted(b.length for b in packed.buckets)) <= expect
    assert packed.n_reads == 10
    # every read landed in the smallest bucket that fits
    for b in packed.buckets:
        real = b.read_index >= 0
        assert np.all(b.lengths[real] <= b.length)


def test_encode_bases():
    codes = encode_bases("ACGTacgtNX")
    assert list(codes[:8]) == [0, 1, 2, 3, 0, 1, 2, 3]
    assert codes[8] == INVALID and codes[9] == INVALID


def test_pack_reads_buckets_and_padding():
    recs = [
        FastxRecord("a", "ACGT" * 10),     # 40 -> bucket 64
        FastxRecord("b", "A" * 100),       # 100 -> bucket 128
        FastxRecord("c", "C" * 300),       # 300 -> truncated to 128
        FastxRecord("d", "G" * 8),         # 8 -> bucket 64
    ]
    packed = pack_reads(recs, length_buckets=(64, 128), pad_rows_to=4)
    assert packed.n_reads == 4
    assert packed.n_truncated == 1
    by_len = {b.bases.shape[1]: b for b in packed.buckets}
    assert set(by_len) == {64, 128}
    b64 = by_len[64]
    assert b64.bases.shape[0] % 4 == 0
    assert set(b64.read_index[:2]) == {0, 3}
    # padding rows flagged with read_index -1 and all-INVALID bases
    pad_rows = b64.read_index == -1
    assert np.all(b64.bases[pad_rows] == INVALID)
    b128 = by_len[128]
    row_c = int(np.where(b128.read_index == 2)[0][0])
    assert b128.lengths[row_c] == 128  # truncated
