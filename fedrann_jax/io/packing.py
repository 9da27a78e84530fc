"""Host-side read packing: strings -> fixed-shape base-code arrays.

Compiled device programs need static shapes, so variable-length reads are grouped into
length buckets and padded. Base encoding A=0 C=1 G=2 T=3 matches the
reference's 2-bit code (kmer_searcher.cpp:138-151); any other character maps
to the INVALID code 4 — windows covering an invalid base emit no k-mer, the
same behavior as the reference's UINT64_MAX window reset
(kmer_searcher.cpp:314-349).

A C++ fast path for parse+pack lives in native/ (ctypes); this numpy
implementation is the reference-correct fallback and the unit-test oracle.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from fedrann_jax.io.fastx import FastxRecord
from fedrann_jax.logging_utils import logger

INVALID = np.uint8(4)


def full_fast(shape, value, dtype) -> np.ndarray:
    """np.full replacement: np.zeros + broadcast-set. On the throttled VMs
    this code runs on, np.full's scalar fill path is ~300x slower than a
    vectorized store over fresh zero pages (measured 11 s vs 0.03 s for
    49 MB)."""
    out = np.zeros(shape, dtype=dtype)
    if value:
        out[...] = value
    return out

_BASE_LUT = np.full(256, INVALID, dtype=np.uint8)
for _ch, _code in (("A", 0), ("C", 1), ("G", 2), ("T", 3)):
    _BASE_LUT[ord(_ch)] = _code
    _BASE_LUT[ord(_ch.lower())] = _code


def encode_bases(seq: str) -> np.ndarray:
    """ASCII sequence -> uint8 codes in {0,1,2,3,4}."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _BASE_LUT[raw]


@dataclasses.dataclass
class PackedBucket:
    """Reads padded to one bucket length.

    Either `bases` (1 byte/base) or the bit-packed pair
    (`packed_bases` 4 bases/byte + `valid_bits` 1 bit/base) is populated;
    the bit-packed form shrinks host->device uploads ~3.6x and is unpacked
    on device (fedrann_jax.kmers.codec.unpack_bases)."""

    bases: np.ndarray | None       # (R_b, L_bucket) uint8, INVALID-padded
    lengths: np.ndarray            # (R_b,) int32 true lengths
    read_index: np.ndarray         # (R_b,) int32 global read order index
    packed_bases: np.ndarray | None = None  # (R_b, ceil(L/4)) uint8
    valid_bits: np.ndarray | None = None    # (R_b, ceil(L/8)) uint8
    length: int = 0                # L_bucket (needed when bases is None)
    # True => every row's validity is a pure length prefix (no mid-read
    # invalid bases), so the device upload can ride per-row lengths and
    # skip the valid_bits plane. None => unknown (derive by popcount);
    # the native packer caches the answer at fill time.
    prefix_valid: bool | None = None


@dataclasses.dataclass
class PackedReads:
    names: list[str]                 # global read order = input file order
    buckets: list[PackedBucket]      # ascending bucket length
    n_truncated: int = 0
    # reads split into multiple bucket rows (ultra-long reads, see
    # segment_spans); their rows share one read_index, and the embedding
    # stage merges their hit sets (pipeline.compute_embeddings)
    split_read_ids: np.ndarray | None = None

    @property
    def n_reads(self) -> int:
        return len(self.names)


def segment_spans(length: int, max_len: int, overlap: int) -> list[tuple[int, int]]:
    """(start, len) spans splitting a read of `length` bases into segments
    of at most max_len with `overlap` shared bases between consecutive
    segments. With overlap = k-1, every k-window of the read appears in
    EXACTLY one segment (segment j owns windows starting in
    [j*stride, j*stride + stride)), so k-mer multiplicity counts over the
    segment stream equal the unsplit read's — the reference streams
    unbounded reads (fastx_io.py:158-183); this is the static-shape
    equivalent."""
    stride = max_len - overlap
    if stride <= 0:
        raise ValueError(f"overlap {overlap} >= segment length {max_len}")
    spans = []
    start = 0
    while True:
        seg = min(max_len, length - start)
        spans.append((start, seg))
        if start + seg >= length:
            return spans
        start += stride


def auto_length_buckets(
    lengths,
    floor: int = 1024,
    cap: int = 262144,
    min_frac: float = 0.02,
    max_buckets: int = 8,
) -> tuple[int, ...]:
    """Power-of-two bucket ladder derived from the read-length histogram.

    Every downstream device stage (candidate staging, the blocked
    selection sort, the embed gather) does work proportional to the PADDED
    read length, so coarse fixed buckets tax real rungs heavily: 15 kb
    HiFi reads in a 65536 bucket leave 77% of the staged window slots
    dead. The ladder here is the set of pow2 size classes the reads
    actually occupy, with low-mass classes (< min_frac of reads) merged
    upward so the compiled-program set stays small, clamped to
    [floor, cap] (reads past cap are chunk-split as before). Deterministic
    in the input lengths."""
    lengths = np.asarray(lengths, dtype=np.int64)
    lengths = lengths[lengths > 0]
    if lengths.size == 0:
        return (int(floor),)
    classes = np.maximum(
        floor, 1 << np.ceil(np.log2(lengths)).astype(np.int64)
    )
    classes = np.minimum(classes, cap)
    uniq, counts = np.unique(classes, return_counts=True)
    total = int(counts.sum())
    keep: list[int] = []
    mass: list[int] = []
    carried = 0
    for c, n in zip(uniq, counts):
        carried += int(n)
        if carried >= min_frac * total or c == uniq[-1]:
            keep.append(int(c))
            mass.append(carried)
            carried = 0
    # bound the ladder: merge the least-populated bucket upward (its reads
    # fit the next bucket by construction; the largest never merges away)
    while len(keep) > max_buckets:
        i = int(np.argmin(mass[:-1]))
        mass[i + 1] += mass[i]
        del keep[i], mass[i]
    return tuple(keep)


def pack_reads(
    records: Iterable[FastxRecord],
    length_buckets: Sequence[int] | None,
    pad_rows_to: int = 8,
    split_overlap: int | None = None,
) -> PackedReads:
    """Group reads into the smallest bucket that fits. length_buckets=None
    derives the ladder from the data (auto_length_buckets). Reads longer
    than the largest bucket are chunk-split into overlapping segments when
    split_overlap (= k-1) is given, else truncated (counted + logged). Row
    counts per bucket are padded up to a multiple of `pad_rows_to` with
    all-INVALID rows (read_index -1) so downstream device shapes stay
    tile-friendly."""
    if length_buckets is None:
        records = list(records)
        length_buckets = auto_length_buckets(
            [len(r.sequence) for r in records]
        )
        logger.info("auto length buckets: %s", length_buckets)
    buckets = sorted(length_buckets)
    names: list[str] = []
    per_bucket: list[list[np.ndarray]] = [[] for _ in buckets]
    per_bucket_idx: list[list[int]] = [[] for _ in buckets]
    per_bucket_len: list[list[int]] = [[] for _ in buckets]
    n_truncated = 0
    split_ids: list[int] = []

    for i, rec in enumerate(records):
        names.append(rec.name)
        codes = encode_bases(rec.sequence)
        b = np.searchsorted(buckets, len(codes))
        if b == len(buckets):
            b = len(buckets) - 1
            if split_overlap is not None:
                split_ids.append(i)
                for start, seg in segment_spans(
                    len(codes), buckets[b], split_overlap
                ):
                    sb = int(np.searchsorted(buckets, seg))
                    sb = min(sb, len(buckets) - 1)
                    per_bucket[sb].append(codes[start : start + seg])
                    per_bucket_idx[sb].append(i)
                    per_bucket_len[sb].append(seg)
                continue
            codes = codes[: buckets[b]]
            n_truncated += 1
        per_bucket[b].append(codes)
        per_bucket_idx[b].append(i)
        per_bucket_len[b].append(len(codes))

    if n_truncated:
        logger.warning(
            "%d reads longer than the largest length bucket (%d) were truncated",
            n_truncated,
            buckets[-1],
        )
    if split_ids:
        logger.info(
            "%d reads longer than the largest bucket (%d) were chunk-split",
            len(split_ids), buckets[-1],
        )

    out: list[PackedBucket] = []
    for b, rows in enumerate(per_bucket):
        if not rows:
            continue
        n_rows = len(rows)
        padded_rows = -(-n_rows // pad_rows_to) * pad_rows_to
        mat = full_fast((padded_rows, buckets[b]), INVALID, np.uint8)
        # prefix_valid is known for free at fill time (ADVICE r3): a row's
        # validity is a pure length prefix iff no mid-read base is INVALID
        prefix_valid = True
        for r, codes in enumerate(rows):
            mat[r, : len(codes)] = codes
            if prefix_valid and codes.max(initial=0) >= INVALID:
                prefix_valid = False
        lengths = np.zeros(padded_rows, dtype=np.int32)
        lengths[:n_rows] = per_bucket_len[b]
        read_index = full_fast(padded_rows, -1, np.int32)
        read_index[:n_rows] = per_bucket_idx[b]
        out.append(PackedBucket(bases=mat, lengths=lengths, read_index=read_index,
                                length=buckets[b], prefix_valid=prefix_valid))

    return PackedReads(
        names=names, buckets=out, n_truncated=n_truncated,
        split_read_ids=np.asarray(split_ids, np.int32) if split_ids else None,
    )
