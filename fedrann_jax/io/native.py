"""ctypes bindings for the native FASTX parser (native/fastxpack.cpp).

The native path parses + 2-bit-encodes reads in C++ (zlib for .gz) and
hands numpy zero-copy views; pack_reads_native buckets them with vectorized
numpy. The library is built from source with `make -C native` at first use
(ensure_built); where it cannot be built, load_native returns None and
callers degrade to the pure-Python reader (fedrann_jax/io/fastx.py), which
is the behavioral oracle for this module's tests.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from fedrann_jax.io.packing import INVALID, PackedBucket, PackedReads, full_fast
from fedrann_jax.logging_utils import logger

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_SO_NAME = "libfastxpack.so"


class _FastxParsed(ctypes.Structure):
    _fields_ = [
        ("codes", ctypes.POINTER(ctypes.c_uint8)),
        ("offsets", ctypes.POINTER(ctypes.c_uint64)),
        # POINTER(c_char), NOT c_char_p: the buffer is NUL-separated and
        # c_char_p would truncate at the first NUL on attribute access
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("name_offsets", ctypes.POINTER(ctypes.c_uint64)),
        ("n_reads", ctypes.c_uint64),
        ("total_bases", ctypes.c_uint64),
        ("names_bytes", ctypes.c_uint64),
    ]


class _FastxScan(ctypes.Structure):
    _fields_ = [
        ("rec_offsets", ctypes.POINTER(ctypes.c_uint64)),
        ("names", ctypes.POINTER(ctypes.c_char)),
        ("name_offsets", ctypes.POINTER(ctypes.c_uint64)),
        ("n_records", ctypes.c_uint64),
        ("names_bytes", ctypes.c_uint64),
    ]


def ensure_built(native_dir: str = NATIVE_DIR) -> Optional[str]:
    """Path of the native library, built with `make` when it is missing or
    older than fastxpack.cpp; None when it cannot be built. A lock file
    serializes concurrent first uses (test workers, ranks on one host), and
    each build writes a temporary name that is renamed into place, so no
    process ever loads a half-written library."""
    so = os.path.join(native_dir, _SO_NAME)
    src = os.path.join(native_dir, "fastxpack.cpp")

    def fresh() -> bool:
        return (os.path.exists(so)
                and os.path.getmtime(so) >= os.path.getmtime(src))

    if not os.path.exists(src) or fresh():
        return so if os.path.exists(so) else None
    import fcntl
    import subprocess

    tmp = f"{_SO_NAME}.tmp{os.getpid()}"
    try:
        with open(os.path.join(native_dir, ".build.lock"), "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if fresh():
                return so
            subprocess.run(["make", "-s", "-C", native_dir, f"OUT={tmp}"],
                           check=True, capture_output=True, text=True)
            os.replace(os.path.join(native_dir, tmp), so)
    except (OSError, subprocess.CalledProcessError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        logger.warning("native FASTX library not built (%s); using the "
                       "Python parser", detail.strip().splitlines()[-1:])
        if os.path.exists(os.path.join(native_dir, tmp)):
            os.remove(os.path.join(native_dir, tmp))
        return None
    logger.info("built %s", so)
    return so


_lib = None
_unavailable = False


def load_native() -> Optional[ctypes.CDLL]:
    global _lib, _unavailable
    if _lib is not None or _unavailable:
        return _lib
    so = ensure_built()
    if so is None:
        _unavailable = True
        return None
    lib = ctypes.CDLL(so)
    lib.fastx_parse.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FastxParsed)]
    lib.fastx_parse.restype = ctypes.c_int
    lib.fastx_parse_threads.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(_FastxParsed)
    ]
    lib.fastx_parse_threads.restype = ctypes.c_int
    lib.fastx_free.argtypes = [ctypes.POINTER(_FastxParsed)]
    lib.fastx_free.restype = None
    lib.fastx_parse_range.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int,
        ctypes.POINTER(_FastxParsed),
    ]
    lib.fastx_parse_range.restype = ctypes.c_int
    lib.fastx_scan_range.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.POINTER(_FastxScan),
    ]
    lib.fastx_scan_range.restype = ctypes.c_int
    lib.fastx_scan_free.argtypes = [ctypes.POINTER(_FastxScan)]
    lib.fastx_scan_free.restype = None
    lib.fastx_is_plain_fasta.argtypes = [ctypes.c_char_p]
    lib.fastx_is_plain_fasta.restype = ctypes.c_int
    lib.fastx_fill_bucket.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # codes
        ctypes.POINTER(ctypes.c_uint64),  # offsets
        ctypes.POINTER(ctypes.c_int32),   # rows
        ctypes.c_uint64,                  # n_rows
        ctypes.c_uint64,                  # bucket_len
        ctypes.POINTER(ctypes.c_uint8),   # out
    ]
    lib.fastx_fill_bucket.restype = None
    lib.fastx_write_overlaps.argtypes = [
        ctypes.c_char_p,                  # path (appended to)
        ctypes.POINTER(ctypes.c_char),    # names blob (NUL-separated)
        ctypes.POINTER(ctypes.c_uint64),  # name offsets
        ctypes.c_uint64,                  # n_names
        ctypes.POINTER(ctypes.c_int32),   # q_rows
        ctypes.POINTER(ctypes.c_int32),   # t_rows
        ctypes.POINTER(ctypes.c_int32),   # ranks
        ctypes.POINTER(ctypes.c_float),   # dists
        ctypes.c_uint64,                  # n_rows
    ]
    lib.fastx_write_overlaps.restype = ctypes.c_int64
    lib.fastx_fill_bucket_packed.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # codes
        ctypes.POINTER(ctypes.c_uint64),  # offsets
        ctypes.POINTER(ctypes.c_int32),   # rows
        ctypes.c_uint64,                  # n_rows
        ctypes.c_uint64,                  # bucket_len
        ctypes.POINTER(ctypes.c_uint8),   # out_packed
        ctypes.POINTER(ctypes.c_uint8),   # out_valid
    ]
    # returns the count of invalid (non-ACGT) bases in the filled rows;
    # 0 means every row's validity is a pure length prefix (no mid-read
    # N bases), cached on the bucket so the stage loop skips a ~30 MB
    # host popcount re-derivation per run (measured 0.3-4.2 s)
    lib.fastx_fill_bucket_packed.restype = ctypes.c_int64
    lib.fastx_write_overlaps_matrix.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32),   # idx (2R, k)
        ctypes.POINTER(ctypes.c_float),   # dist (2R, k)
        ctypes.c_uint64,                  # n_rows (2R)
        ctypes.c_uint64,                  # k
        ctypes.c_uint64,                  # row_offset (global row of row 0)
    ]
    lib.fastx_write_overlaps_matrix.restype = ctypes.c_int64
    _lib = lib
    return lib


def _names_blob(names):
    # latin-1 is byte-preserving: non-ASCII bytes in FASTX headers round-trip
    # instead of aborting the run after the expensive stages (ADVICE r1)
    blob = b"\x00".join(n.encode("latin-1") for n in names) + b"\x00"
    offsets = np.zeros(len(names), dtype=np.uint64)
    pos = 0
    for i, n in enumerate(names):
        offsets[i] = pos
        pos += len(n) + 1
    return blob, offsets


def write_overlaps_matrix_native(
    path: str, names, idx: np.ndarray, dist: np.ndarray,
    row_offset: int = 0,
) -> int:
    """C writer over the raw (rows, k) neighbor matrices; self rows and
    negative targets are skipped inside the C loop (no numpy filtering).
    row_offset maps local matrix row q to global embedding row
    row_offset+q (multi-host ranks pass their query-range start; names
    stay globally indexed)."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native library not built")
    blob, offsets = _names_blob(names)
    i32 = np.ascontiguousarray(idx, dtype=np.int32)
    d32 = np.ascontiguousarray(dist, dtype=np.float32)
    rc = lib.fastx_write_overlaps_matrix(
        path.encode(),
        ctypes.cast(ctypes.create_string_buffer(blob, len(blob)),
                    ctypes.POINTER(ctypes.c_char)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(names),
        i32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        d32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        i32.shape[0], i32.shape[1], row_offset,
    )
    if rc < 0:
        raise RuntimeError(f"fastx_write_overlaps_matrix failed: {rc}")
    return int(rc)


def write_overlaps_native(
    path: str,
    names: list[str],
    q_rows: np.ndarray,
    t_rows: np.ndarray,
    ranks: np.ndarray,
    dists: np.ndarray,
) -> int:
    """Append pre-filtered overlap rows via the C writer (rows must already
    exclude self/negative targets). Returns rows written."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native library not built")
    blob, offsets = _names_blob(names)
    q32 = np.ascontiguousarray(q_rows, dtype=np.int32)
    t32 = np.ascontiguousarray(t_rows, dtype=np.int32)
    r32 = np.ascontiguousarray(ranks, dtype=np.int32)
    d32 = np.ascontiguousarray(dists, dtype=np.float32)
    rc = lib.fastx_write_overlaps(
        path.encode(),
        ctypes.cast(ctypes.create_string_buffer(blob, len(blob)),
                    ctypes.POINTER(ctypes.c_char)),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(names),
        q32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        t32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        r32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        d32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(q32),
    )
    if rc < 0:
        raise RuntimeError(f"fastx_write_overlaps failed: {rc}")
    return int(rc)


def native_available() -> bool:
    return load_native() is not None


def is_plain_fasta(path: str) -> bool:
    """True when the input is uncompressed FASTA (byte-range parseable:
    gzip has no random access; FASTQ '@' is line-ambiguous)."""
    lib = load_native()
    if lib is None:
        return False
    return bool(lib.fastx_is_plain_fasta(path.encode()))


def scan_records_native(path: str, lo: int, hi: int):
    """Record-boundary scan over file bytes [lo, hi): returns (names list,
    absolute byte offsets int64 array) for every record STARTING in the
    range — no base decoding, so a rank scanning 1/ranks of a file does
    ~1/ranks of the I/O. Plain FASTA only (raises otherwise)."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native fastxpack library not built (make -C native)")
    scan = _FastxScan()
    rc = lib.fastx_scan_range(path.encode(), int(lo), int(hi),
                              ctypes.byref(scan))
    if rc != 0:
        raise ValueError(f"fastx_scan_range failed with code {rc} for {path}")
    try:
        n = int(scan.n_records)
        offsets = (np.ctypeslib.as_array(scan.rec_offsets, shape=(max(n, 1),))
                   [:n].astype(np.int64))
        raw = ctypes.string_at(scan.names, scan.names_bytes)
        names = raw.decode("latin-1").split("\x00")[:n]
    finally:
        lib.fastx_scan_free(ctypes.byref(scan))
    return names, offsets


def parse_fastx_native(path: str, threads: int = 1,
                       byte_range: tuple[int, int] | None = None):
    """Parse with the C++ library. Returns (names list, codes uint8 array,
    offsets uint64 array). Raises on parse errors. threads > 1 parallelizes
    plain-FASTA parsing (segmented at record starts); gzip/FASTQ inputs
    stream single-threaded. byte_range=(lo, hi) parses only records in that
    file-byte span (lo/hi must be exact record starts from
    scan_records_native; plain FASTA only)."""
    lib = load_native()
    if lib is None:
        raise RuntimeError("native fastxpack library not built (make -C native)")
    parsed = _FastxParsed()
    if byte_range is not None:
        rc = lib.fastx_parse_range(path.encode(), int(byte_range[0]),
                                   int(byte_range[1]), int(max(1, threads)),
                                   ctypes.byref(parsed))
    else:
        rc = lib.fastx_parse_threads(path.encode(), int(max(1, threads)),
                                     ctypes.byref(parsed))
    if rc != 0:
        raise ValueError(f"fastx_parse failed with code {rc} for {path}")
    try:
        n = parsed.n_reads
        codes = np.ctypeslib.as_array(parsed.codes, shape=(parsed.total_bases,)).copy()
        # int64, not uint64: mixing uint64 with signed ints silently
        # promotes to float64 in numpy arithmetic
        offsets = (
            np.ctypeslib.as_array(parsed.offsets, shape=(n + 1,))
            .astype(np.int64)
        )
        raw_names = ctypes.string_at(parsed.names, parsed.names_bytes)
        names = raw_names.decode("latin-1").split("\x00")[:n]
    finally:
        lib.fastx_free(ctypes.byref(parsed))
    return names, codes, offsets


def pack_reads_native(
    path: str,
    length_buckets: Sequence[int] | None,
    pad_rows_to: int = 8,
    bit_packed: bool = False,
    threads: int = 1,
    split_overlap: int | None = None,
    byte_range: tuple[int, int] | None = None,
) -> PackedReads:
    """Native-parse + vectorized numpy bucketing; behaviorally identical to
    pack_reads(read_fastx(path), ...) (length_buckets=None = the auto
    ladder, packing.auto_length_buckets). bit_packed=True stores the 2-bit
    packed form (4 bases/byte + validity bits) instead of the byte matrix —
    ~3.6x smaller host memory and host->device upload; unpacked on device
    (kmers.codec.unpack_bases). split_overlap (= k-1) chunk-splits reads
    longer than the largest bucket instead of truncating them."""
    from fedrann_jax.io.packing import auto_length_buckets, segment_spans

    names, codes, offsets = parse_fastx_native(path, threads,
                                               byte_range=byte_range)
    lengths = np.diff(offsets).astype(np.int64)
    if length_buckets is None:
        length_buckets = auto_length_buckets(lengths)
        logger.info("auto length buckets: %s", length_buckets)
    buckets = sorted(length_buckets)
    bucket_of = np.searchsorted(buckets, lengths)
    over = np.flatnonzero(bucket_of == len(buckets))
    split_ids = None
    n_truncated = 0
    # (read_index, start, seg_len) triples; in-bucket reads are whole spans
    seg_read = np.arange(len(lengths), dtype=np.int64)
    seg_start = np.zeros(len(lengths), dtype=np.int64)
    seg_len = lengths.copy()
    if split_overlap is not None and len(over):
        split_ids = over.astype(np.int32)
        extra_read, extra_start, extra_len = [], [], []
        for r in over:
            for start, seg in segment_spans(
                int(lengths[r]), buckets[-1], split_overlap
            ):
                extra_read.append(r)
                extra_start.append(start)
                extra_len.append(seg)
        keep = np.ones(len(lengths), dtype=bool)
        keep[over] = False
        seg_read = np.concatenate([seg_read[keep], extra_read])
        seg_start = np.concatenate([seg_start[keep], extra_start])
        seg_len = np.concatenate([seg_len[keep], extra_len])
        logger.info(
            "%d reads longer than the largest bucket (%d) were chunk-split",
            len(over), buckets[-1],
        )
    else:
        n_truncated = len(over)
        if n_truncated:
            logger.warning(
                "%d reads longer than the largest length bucket (%d) were "
                "truncated", n_truncated, buckets[-1],
            )
    bucket_of = np.minimum(np.searchsorted(buckets, seg_len),
                           len(buckets) - 1)
    # virtual offset pairs: the C fill functions read offsets[r] and
    # offsets[r+1], so segment (start, len) becomes the consecutive pair
    # (base+start, base+start+len) at virtual row 2i
    virt_offsets = np.empty(2 * len(seg_read), dtype=np.uint64)
    virt_offsets[0::2] = offsets[seg_read] + seg_start
    virt_offsets[1::2] = offsets[seg_read] + seg_start + seg_len

    out = []
    for b, bucket_len in enumerate(buckets):
        rows = np.flatnonzero(bucket_of == b)
        if len(rows) == 0:
            continue
        padded_rows = -(-len(rows) // pad_rows_to) * pad_rows_to
        blens = np.minimum(seg_len[rows], bucket_len)
        lib = load_native()
        rows32 = np.ascontiguousarray(2 * rows, dtype=np.int32)
        offsets64 = virt_offsets
        lens_arr = np.zeros(padded_rows, dtype=np.int32)
        lens_arr[: len(rows)] = blens
        read_index = full_fast(padded_rows, -1, np.int32)
        read_index[: len(rows)] = seg_read[rows]
        if bit_packed:
            pk = np.zeros((padded_rows, (bucket_len + 3) // 4), np.uint8)
            vd = np.zeros((padded_rows, (bucket_len + 7) // 8), np.uint8)
            n_invalid = lib.fastx_fill_bucket_packed(
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                offsets64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                rows32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                len(rows), bucket_len,
                pk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                vd.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            )
            out.append(PackedBucket(
                bases=None, lengths=lens_arr, read_index=read_index,
                packed_bases=pk, valid_bits=vd, length=bucket_len,
                prefix_valid=(n_invalid == 0),
            ))
            continue
        mat = full_fast((padded_rows, bucket_len), INVALID, np.uint8)
        lib.fastx_fill_bucket(
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            rows32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(rows), bucket_len,
            mat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        out.append(PackedBucket(bases=mat, lengths=lens_arr, read_index=read_index,
                                length=bucket_len))

    return PackedReads(names=names, buckets=out, n_truncated=n_truncated,
                       split_read_ids=split_ids)
