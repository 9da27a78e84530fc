"""Reference-artifact interop: load FEDRANN intermediates for golden tests.

The recall metric compares against the reference's outputs; when a
reference run's intermediates are available (--keep-intermediates there),
these loaders let our pipeline consume them directly so embedding-level
parity can be isolated from library-sampling differences (SURVEY.md §7.3
"import reference P" path):

- jellyfish-dump k-mer library FASTA: header `>count`, sequence = k-mer
  (reference count_kmers.py:104-123, parsed by precompute.py:44-55)
- scipy sparse precompute matrix .npz (reference precompute.py:109-115)
- `output.bin` per-read library index sets ("KMER" v1 binary, written by
  kmer_searcher.cpp:98-130, read by feature_extraction.py:108-140)

Index-space mapping: the reference's feature index f is the k-mer's
first-appearance position in the concatenated fwd+rev library stream
(kmer_searcher.cpp:262-273); ours is the rank of the canonical code in the
sorted sampled library, with the [L, 2L) half meaning "read strand was the
reverse complement" (SURVEY.md §2.5, kmers/membership.py). A library file
entry whose string is NOT canonical under our coding flips halves: our
"forward" condition for that feature equals the reference's "reverse".
`load_reference_library_mapping` returns the extended-index permutation
that accounts for both the sort reorder and these flips, so a reference
precompute matrix can be permuted into our index space exactly.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

from fedrann_jax.io.fastx import read_fastx
from fedrann_jax.io.packing import encode_bases
from fedrann_jax.oracle import KmerLibrary, canonical_code, kmer_code


def _parse_library_entries(fasta_path: str, k: int):
    """Yield (our_canonical_code, count, was_flipped) per valid entry."""
    for rec in read_fastx(fasta_path):
        seq = rec.sequence
        if len(seq) != k:
            # tokens of the wrong length are skipped, mirroring the
            # reference scanner's tolerance (kmer_searcher.cpp:262-273)
            continue
        code = kmer_code(encode_bases(seq), k)
        if len(code) != 1 or code[0] == np.uint64(0xFFFFFFFFFFFFFFFF):
            continue
        canon = canonical_code(code[:1], k)[0]
        try:
            count = int(rec.name)
        except ValueError:
            count = 1
        yield canon, count, bool(canon != code[0])


def load_reference_library(fasta_path: str, k: int) -> KmerLibrary:
    """Read a jellyfish-dump-format library (`>count\\nKMER`), returning a
    KmerLibrary sorted by OUR canonical code. Entries are canonicalized
    under our min(code, revcomp) rule — jellyfish's canonical choice uses a
    different base ordering (A=0 C=1 G=3 T=2 there), so a real dump can
    contain k-mer strings that are non-canonical for us; membership search
    compares canonical codes, so storing the string's raw code would
    silently drop those features."""
    lib, _ = load_reference_library_mapping(fasta_path, k)
    return lib


def load_reference_library_mapping(
    fasta_path: str, k: int
) -> tuple[KmerLibrary, np.ndarray]:
    """Library plus the extended-index permutation into the reference's
    feature space.

    Returns (library, perm) with perm shaped (2L+1,): our extended feature
    index i (i<L: read strand == canonical; i in [L,2L): read strand was
    the revcomp; 2L: sentinel) maps to reference extended index perm[i]
    (file position f for the listed string, f+L for its revcomp, 2L for the
    sentinel). An entry listed in flipped (non-canonical) form swaps the
    two halves for that feature."""
    codes, counts, flipped = [], [], []
    for canon, count, flip in _parse_library_entries(fasta_path, k):
        codes.append(canon)
        counts.append(count)
        flipped.append(flip)
    codes_arr = np.asarray(codes, dtype=np.uint64)
    counts_arr = np.asarray(counts, dtype=np.int64)
    flipped_arr = np.asarray(flipped, dtype=bool)
    file_pos = np.arange(len(codes_arr), dtype=np.int64)
    order = np.argsort(codes_arr, kind="stable")
    codes_arr = codes_arr[order]
    counts_arr = counts_arr[order]
    flipped_arr = flipped_arr[order]
    file_pos = file_pos[order]
    # de-duplicate (palindrome/cross-listing tolerance, SURVEY.md §2.5.3):
    # keep the FIRST file occurrence of each canonical code, matching the
    # reference scanner's first-appearance duplicate suppression
    if len(codes_arr):
        keep = np.concatenate([[True], codes_arr[1:] != codes_arr[:-1]])
        codes_arr, counts_arr = codes_arr[keep], counts_arr[keep]
        flipped_arr, file_pos = flipped_arr[keep], file_pos[keep]
    lib = KmerLibrary(codes=codes_arr, counts=counts_arr)
    size = len(codes_arr)
    n_file = max(len(codes), 1)
    perm = np.empty(2 * size + 1, dtype=np.int64)
    # our fwd half: read strand == our canonical. If the file listed the
    # canonical string (not flipped), the reference scanner matches it on
    # the forward stream -> index file_pos; if flipped, our-fwd hits the
    # file string's revcomp -> reference index file_pos + L_file.
    perm[:size] = np.where(flipped_arr, file_pos + len(codes), file_pos)
    perm[size : 2 * size] = np.where(flipped_arr, file_pos,
                                     file_pos + len(codes))
    perm[2 * size] = 2 * n_file  # sentinel row (see load_reference_precompute)
    return lib, perm


def load_reference_precompute(
    npz_path: str, perm: np.ndarray | None = None
) -> np.ndarray:
    """Load a scipy-sparse CSR .npz of the reference precompute matrix
    P (n_features, n_components) as dense float32 with the trailing zero
    sentinel row appended (our embed_hits contract). With perm (from
    load_reference_library_mapping), rows are permuted into our extended
    index space so our membership indices select exactly the reference's
    projection rows."""
    import scipy.sparse as sp

    p = sp.load_npz(npz_path).toarray().astype(np.float32)
    p_ext = np.concatenate([p, np.zeros((1, p.shape[1]), np.float32)])
    if perm is None:
        return p_ext
    if perm.max() >= p_ext.shape[0]:
        raise ValueError(
            f"permutation references row {perm.max()} but precompute has "
            f"{p_ext.shape[0]} rows (library/projection mismatch?)"
        )
    return p_ext[perm]


# --- output.bin ("KMER" v1) ------------------------------------------------

def read_reference_scan(path: str) -> Iterator[tuple[str, np.ndarray]]:
    """Stream (read_name, forward-row library indices) records from a
    kmer_searcher output.bin (format: kmer_searcher.cpp:98-130; little
    endian: 4s magic 'KMER', u8 version=1, 3 reserved bytes, u64 record
    count; per record u16 id_len, id bytes, u32 index_count, u64 indices).
    Only the forward row is stored; the reverse row is index arithmetic
    (feature_extraction.py:137-140 — see mirror_reference_indices)."""
    with open(path, "rb") as f:
        header = f.read(16)
        if len(header) < 16:
            raise ValueError(f"{path}: truncated output.bin header")
        magic, version, _reserved, total = struct.unpack("<4sB3sQ", header)
        if magic != b"KMER":
            raise ValueError(f"{path}: bad magic {magic!r}")
        if version != 1:
            raise ValueError(f"{path}: unsupported version {version}")
        for _ in range(total):
            raw = f.read(2)
            if len(raw) < 2:
                raise ValueError(f"{path}: truncated record header")
            (id_len,) = struct.unpack("<H", raw)
            name = f.read(id_len).decode("latin-1")
            (count,) = struct.unpack("<I", f.read(4))
            data = f.read(8 * count)
            if len(data) < 8 * count:
                raise ValueError(f"{path}: truncated index block for {name}")
            yield name, np.frombuffer(data, dtype="<u8").astype(np.int64)


def load_reference_scan(path: str) -> tuple[list[str], list[np.ndarray]]:
    """Materialize output.bin as (names, per-read forward index arrays)."""
    names, rows = [], []
    for name, idx in read_reference_scan(path):
        names.append(name)
        rows.append(idx)
    return names, rows


def mirror_reference_indices(indices: np.ndarray, kmer_count: int) -> np.ndarray:
    """The reference's reverse-row index mirror i <-> i+kmer_count
    (feature_extraction.py:137-140)."""
    return np.where(indices < kmer_count, indices + kmer_count,
                    indices - kmer_count)


def embed_reference_rows(
    rows: list[np.ndarray],
    p_ext: np.ndarray,
    kmer_count: int,
) -> np.ndarray:
    """Feed reference per-read index sets through our embedding math:
    E row = sum of precompute rows at the read's indices (binary presence
    times P — reference feature_extraction.py:204-213), with the fwd/rev
    interleaved (2R, d) layout of reference __main__.py:277-282. p_ext is
    in the REFERENCE index space (load_reference_precompute without perm)."""
    d = p_ext.shape[1]
    out = np.zeros((2 * len(rows), d), dtype=np.float32)
    for r, idx in enumerate(rows):
        if len(idx):
            out[2 * r] = p_ext[idx].sum(axis=0)
            out[2 * r + 1] = p_ext[mirror_reference_indices(idx, kmer_count)].sum(axis=0)
    return out
