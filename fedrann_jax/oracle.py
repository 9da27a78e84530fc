"""Numpy oracle: the exact pipeline semantics, small-scale and readable.

This module is the golden standard for every device kernel and for end-to-end
tests. It implements the behavior described in SURVEY.md §2.5-§2.7 with the
ambiguities resolved deterministically:

- canonical k-mer coding (min(code, revcomp)) replaces jellyfish -C plus the
  explicit reverse library (reference fedrann/count_kmers.py:80-139);
- library sampling by seeded hash threshold replaces the awk rand() stream
  (reference count_kmers.py:104-123) — order-free and deterministic;
- feature space: sampled library of L canonical k-mers sorted by code; index
  f in [0, L) = read-strand k-mer equals the canonical form, f + L = it was
  the reverse complement (the reference's fwd/rev concatenated-library index
  halves, count_kmers.py:137 + kmer_searcher.cpp:262-273, made exact);
- the reverse-complement row of a read mirrors indices i <-> i+L without
  rescanning (reference feature_extraction.py:137-140);
- binary presence semantics (reference kmer_searcher.cpp:309/327);
- ICF = log(n_features / (count + 1e-12)) shared by both halves (reference
  precompute.py:71-77);
- SRP with density 1/sqrt(n_features), values +-1, scale
  sqrt(1/density)/sqrt(d) (reference precompute.py:80-107);
- exact cosine k-NN (replaces pynndescent; reference nearest_neighbors.py),
  reads with zero hits get zero embeddings and are never dropped (fixing the
  row-shift hazard at reference feature_extraction.py:188-189).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from fedrann_jax.io.packing import encode_bases

# --- 2-bit codec -----------------------------------------------------------

def kmer_code(seq_codes: np.ndarray, k: int) -> np.ndarray:
    """All k-length window codes of a base-code vector; windows containing an
    invalid base (code > 3) return the sentinel 2**64-1 (matches the
    reference's UINT64_MAX invalid-window contract, kmer_searcher.cpp:138-151).
    """
    n = len(seq_codes)
    if n < k:
        return np.zeros(0, dtype=np.uint64)
    valid = seq_codes < 4
    codes = np.zeros(n - k + 1, dtype=np.uint64)
    ok = np.ones(n - k + 1, dtype=bool)
    for j in range(k):
        window = seq_codes[j : j + n - k + 1].astype(np.uint64)
        codes = (codes << np.uint64(2)) | np.where(valid[j : j + n - k + 1], window, 0)
        ok &= valid[j : j + n - k + 1]
    codes[~ok] = np.uint64(0xFFFFFFFFFFFFFFFF)
    return codes


def revcomp_code(codes: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement of 2-bit k-mer codes: complement = XOR 0b11 per
    base; reverse base order."""
    codes = np.asarray(codes, dtype=np.uint64)
    out = np.zeros_like(codes)
    tmp = codes.copy()
    for _ in range(k):
        out = (out << np.uint64(2)) | ((tmp & np.uint64(3)) ^ np.uint64(3))
        tmp >>= np.uint64(2)
    return out


def canonical_code(codes: np.ndarray, k: int) -> np.ndarray:
    rc = revcomp_code(codes, k)
    return np.minimum(codes, rc)


# --- sampling hash ---------------------------------------------------------

def splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (public-domain splitmix64 constants); used to
    turn canonical codes into uniform hashes for threshold sampling."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        z = x + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    return z


def fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3 32-bit finalizer. The library-sampling hash is defined in
    uint32 ops so that device code works on 32-bit words only (CLAUDE.md:
    device ints are uint32 word tuples)."""
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
    return x


def sample_hash32(codes: np.ndarray, seed: int) -> np.ndarray:
    """The library-sampling hash: uint32, defined on the (hi, lo) words of
    the canonical code. Deterministic and order-free, so every host/chip
    reconstructs the same sample with zero communication."""
    codes = np.asarray(codes, dtype=np.uint64)
    lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (codes >> np.uint64(32)).astype(np.uint32)
    s1 = fmix32(np.uint32(seed & 0xFFFFFFFF))
    s2 = fmix32(s1 ^ np.uint32(0x9E3779B9))
    h1 = fmix32(lo ^ s1)
    h2 = fmix32(hi ^ s2 ^ h1)
    return fmix32(h1 ^ h2)


def sample_mask(codes: np.ndarray, fraction: float, seed: int) -> np.ndarray:
    """Keep a canonical code iff sample_hash32(code) < fraction * 2**32."""
    if fraction >= 1.0:
        return np.ones(len(codes), dtype=bool)
    threshold = np.uint32(min(int(fraction * 2.0**32), 2**32 - 1))
    return sample_hash32(codes, seed) < threshold


# --- library construction --------------------------------------------------

@dataclasses.dataclass
class KmerLibrary:
    codes: np.ndarray    # (L,) uint64 canonical codes, sorted ascending
    counts: np.ndarray   # (L,) int64 canonical multiplicities

    @property
    def size(self) -> int:
        return len(self.codes)

    @property
    def n_features(self) -> int:
        return 2 * len(self.codes)


def build_library(
    sequences: list[str],
    k: int,
    min_multiplicity: int,
    sample_fraction: float,
    seed: int,
) -> KmerLibrary:
    """Canonical counting -> multiplicity filter -> hash-threshold sampling.

    Replaces jellyfish count -C / dump -L / awk sampling / seqkit revcomp
    (reference count_kmers.py:52-149) in one deterministic step.
    """
    all_codes = []
    for seq in sequences:
        c = kmer_code(encode_bases(seq), k)
        c = c[c != np.uint64(0xFFFFFFFFFFFFFFFF)]
        all_codes.append(canonical_code(c, k))
    if all_codes:
        flat = np.concatenate(all_codes)
    else:
        flat = np.zeros(0, dtype=np.uint64)
    uniq, counts = np.unique(flat, return_counts=True)
    keep = counts >= min_multiplicity
    uniq, counts = uniq[keep], counts[keep]
    smask = sample_mask(uniq, sample_fraction, seed)
    return KmerLibrary(codes=uniq[smask], counts=counts[smask].astype(np.int64))


# --- per-read feature rows -------------------------------------------------

def read_feature_indices(seq: str, k: int, library: KmerLibrary) -> np.ndarray:
    """Sorted unique feature indices of the forward scan of one read.

    f in [0, L): window equals library canonical code as-is;
    f + L: window was the reverse complement of the library code.
    A palindromic window (code == revcomp) maps to the forward half only —
    the deterministic resolution of the reference's dedup ambiguity
    (SURVEY.md §2.5 item 3).
    """
    codes = kmer_code(encode_bases(seq), k)
    codes = codes[codes != np.uint64(0xFFFFFFFFFFFFFFFF)]
    if len(codes) == 0:
        return np.zeros(0, dtype=np.int64)
    rc = revcomp_code(codes, k)
    canon = np.minimum(codes, rc)
    pos = np.searchsorted(library.codes, canon)
    pos = np.clip(pos, 0, max(library.size - 1, 0))
    hit = (library.size > 0) & (library.codes[pos] == canon)
    is_fwd = codes <= rc
    feat = np.where(is_fwd, pos, pos + library.size)
    return np.unique(feat[hit])


def mirror_indices(feat: np.ndarray, library_size: int) -> np.ndarray:
    """Reverse-complement row via index mirror i <-> i+L (reference
    feature_extraction.py:137-140)."""
    return np.sort(np.where(feat < library_size, feat + library_size, feat - library_size))


def feature_rows(sequences: list[str], k: int, library: KmerLibrary) -> list[np.ndarray]:
    """2R rows in (read0_fwd, read0_rev, read1_fwd, ...) order (reference
    __main__.py:277-282)."""
    rows = []
    for seq in sequences:
        fwd = read_feature_indices(seq, k, library)
        rows.append(fwd)
        rows.append(mirror_indices(fwd, library.size))
    return rows


# --- projection ------------------------------------------------------------

def icf_weights(library: KmerLibrary) -> np.ndarray:
    """(2L,) float32; both halves share the canonical multiplicity
    (reference precompute.py:44-77)."""
    n_features = library.n_features
    counts = np.concatenate([library.counts, library.counts]).astype(np.float64)
    return np.log(n_features / (counts + 1e-12)).astype(np.float32)


def srp_rows(
    features: np.ndarray, n_features: int, n_components: int, seed: int,
    density: float | None = None,
) -> np.ndarray:
    """Rows `features` of the dense (n_features, n_components) SRP with the
    reference's distribution (precompute.py:80-107): entry nonzero w.p.
    density, value +-sqrt(1/density)/sqrt(n_components). Our RNG stream
    (splitmix64 per (feature, component)) differs from numpy's Generator by
    design — distributional equivalence is what the recall metric
    requires. Each entry depends only on its (feature, component) pair, so
    any subset of rows is exact without building the whole matrix."""
    if density is None:
        density = 1.0 / np.sqrt(n_features)
    f = np.asarray(features, dtype=np.uint64)[:, None]
    c = np.arange(n_components, dtype=np.uint64)[None, :]
    with np.errstate(over="ignore"):
        h = splitmix64(f * np.uint64(0x9E3779B97F4A7C15) + c + splitmix64(np.uint64(seed)))
    nonzero = (h >> np.uint64(1)) < np.uint64(int(density * 2.0**63))
    sign = np.where((h & np.uint64(1)) == 1, 1.0, -1.0)
    scale = np.sqrt(1.0 / density) / np.sqrt(n_components)
    return (nonzero * sign * scale).astype(np.float32)


def srp_matrix(
    n_features: int, n_components: int, seed: int, density: float | None = None
) -> np.ndarray:
    """The whole dense (n_features, n_components) SRP (srp_rows)."""
    return srp_rows(np.arange(n_features), n_features, n_components, seed,
                    density)


def embed(
    rows: list[np.ndarray], library: KmerLibrary, n_components: int, seed: int,
    density: float | None = None, dtype=np.float32,
) -> np.ndarray:
    """(2R, d) embeddings: E[r] = sum_{f in hits(r)} icf[f]*SRP[f,:], summed
    in `dtype`. Zero-hit rows are zero vectors (never dropped). Only the
    projection rows the hits touch are generated."""
    icf = icf_weights(library)
    used = (np.unique(np.concatenate(rows)).astype(np.int64) if rows
            else np.zeros(0, np.int64))
    srp = srp_rows(used, library.n_features, n_components, seed, density)
    p = srp.astype(dtype) * icf[used].astype(dtype)[:, None]
    out = np.zeros((len(rows), n_components), dtype=dtype)
    for r, feat in enumerate(rows):
        if len(feat):
            out[r] = p[np.searchsorted(used, feat)].sum(axis=0)
    return out


# --- exact k-NN ------------------------------------------------------------

def knn_cosine(embeddings: np.ndarray, n_neighbors: int):
    """Exact cosine top-k over all rows, self included (it lands at rank 0
    with distance 0, as pynndescent's neighbor_graph does — reference
    SURVEY.md §2.7). Zero rows get distance 1 to everything. Ties broken by
    lower index (stable)."""
    e = embeddings.astype(np.float64)
    norms = np.linalg.norm(e, axis=1, keepdims=True)
    norms[norms == 0] = 1.0
    en = e / norms
    sim = en @ en.T
    dist = 1.0 - sim
    k = min(n_neighbors, dist.shape[0])
    idx = np.argsort(dist, axis=1, kind="stable")[:, :k]
    d = np.take_along_axis(dist, idx, axis=1)
    return idx.astype(np.int64), d.astype(np.float32)


# --- full pipeline ---------------------------------------------------------

def run_oracle_pipeline(
    sequences: list[str],
    k: int,
    sample_fraction: float,
    min_multiplicity: int,
    n_components: int,
    n_neighbors: int,
    library_seed: int,
    projection_seed: int,
    density: float | None = None,
):
    """End-to-end oracle. Returns (library, embeddings, indices, distances)."""
    library = build_library(sequences, k, min_multiplicity, sample_fraction, library_seed)
    rows = feature_rows(sequences, k, library)
    emb = embed(rows, library, n_components, projection_seed, density)
    idx, dist = knn_cosine(emb, n_neighbors)
    return library, emb, idx, dist
