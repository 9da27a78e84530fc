"""Per-read library membership: window codes -> feature rows.

Device replacement for the reference's hash-probe hot loop
(kmer_searcher.cpp:308-349): the sampled library is a sorted vector of
uint32 code words, membership is a prefix-table-accelerated binary search,
and the per-read presence *set* (robin_hood::unordered_set there) falls out
of ONE per-row sort of the strand-packed candidate codes.

Design: per-row dynamic gathers (take_along_axis) cost about as much as a
full-width row sort, so a stage->compact->lookup->sort->compact chain (4
gather/scatter passes + 2 sorts) is collapsed into:

  sort(strand-packed codes, non-candidates = all-ones sentinel)   [1 sort]
  -> slice first hit_buffer columns                               [free]
  -> dedup by adjacent equality                                   [elementwise]
  -> prefix-table lookup + verify                                 [the one
                                                                   remaining
                                                                   gather chain]
  -> feature index (pos | pos+L), sentinel-padded IN PLACE        [elementwise]

Feature rows come out sentinel-padded and sorted by (code, strand) — NOT by
feature index, and NOT compacted. Downstream consumers (embedding gather,
device library build) are order/hole-insensitive, so compaction would buy
nothing and cost a gather pass.

Feature index contract (SURVEY.md §2.5, made deterministic):
  f in [0, L)     read-strand k-mer == canonical library code ("forward half")
  f in [L, 2L)    read-strand k-mer was the reverse complement
  sentinel = 2L   padding / miss (maps to an all-zero projection row)
The reverse-complement row of a read is pure index arithmetic
(mirror_hits), exactly the reference's i <-> i+L flip
(feature_extraction.py:137-140) without a second scan.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fedrann_jax.kmers.codec import (
    canonical_window_codes,
    pack_strand,
    u64_to_words,
    unpack_strand,
    words_eq,
    words_less,
)


def library_device_words(lib_codes_u64: np.ndarray, k: int) -> tuple[jax.Array, ...]:
    """Host uint64 library codes -> device uint32 word planes for read_hits."""
    return tuple(jnp.asarray(w) for w in u64_to_words(lib_codes_u64, k))


def _code_prefix(words: tuple, k: int, bits: int) -> jax.Array:
    """Top `bits` bits of the 2k-bit code as uint32 (monotone in code order)."""
    shift = max(2 * k, bits) - bits
    if len(words) == 1:
        return (words[0] >> jnp.uint32(shift)) & jnp.uint32((1 << bits) - 1)
    hi, lo = words
    if shift >= 32:
        out = hi >> jnp.uint32(shift - 32)
    else:
        # shift < 32: prefix straddles the word boundary
        out = (hi << jnp.uint32(32 - shift)) | (lo >> jnp.uint32(shift))
    # mask so the all-ones invalid-window sentinel wraps into a valid bucket
    # (it can never compare equal to a library code, so found stays False)
    return out & jnp.uint32((1 << bits) - 1)


class LibraryIndex:
    """Two-level membership index: a dense prefix table over the sorted
    library plus the word planes. Lookup = one table gather + `steps`
    binary-search refinements. Every gather pass over the (R, HB) query
    matrix costs the same (per-row-bound), so the table is sized ~8x the
    library (buckets mostly 0-1 entries -> 1-2 refinement steps) and,
    when it fits, packs (start<<4 | bucket_len) into one uint32 so the
    lo/hi pair costs ONE gather instead of two."""

    def __init__(self, words: tuple, table: jax.Array, k: int, bits: int,
                 steps: int, packed: bool):
        self.words = words
        self.table = table
        self.k = k
        self.bits = bits
        self.steps = steps
        self.packed = packed


def _index_bits(size: int, k: int) -> int:
    # ~2 entries per bucket on average, capped at a 4M-entry table.
    # (Denser tables measured WORSE: at a 310k library, bits+3 made the
    # host build 60x slower and the device lookup 1.35x slower — the
    # bigger table gather costs more than the 1-2 refinement steps it
    # saves.)
    return min(min(22, max(8, int(size).bit_length())), 2 * k)


@functools.partial(jax.jit, static_argnames=("k", "bits"))
def _bucket_counts_dev(words: tuple, k: int, bits: int) -> jax.Array:
    """Per-bucket entry counts of the prefix table, on device."""
    prefix = _code_prefix(words, k, bits)
    return jnp.bincount(prefix, length=1 << bits).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("packed",))
def _prefix_table_dev(bucket_counts: jax.Array, packed: bool) -> jax.Array:
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(bucket_counts)[:-1].astype(jnp.int32)]
    )
    if packed:
        return ((starts.astype(jnp.uint32) << jnp.uint32(4))
                | bucket_counts.astype(jnp.uint32))
    ends = starts + bucket_counts
    return jnp.concatenate([starts, ends[-1:]])


def build_library_index_device(library, bits: int | None = None
                               ) -> LibraryIndex:
    """Build the membership index FROM a DeviceLibrary without the library
    ever visiting the host: the prefix histogram, cumsum bounds, and packed
    table are device ops over the already-sorted word planes. One scalar
    device->host sync (the max bucket size) picks the refinement-step count
    and the packed/unpacked table form. Replaces the round trip the host
    build pays (D2H of the codes + H2D re-upload of words and table)."""
    words = library.words_dev
    k = library.k
    size = library.size
    if size == 0:
        return build_library_index(np.zeros((0,), np.uint64), k, bits)
    if bits is None:
        bits = _index_bits(size, k)
    bits = min(bits, 2 * k)
    bucket_counts = _bucket_counts_dev(words, k, bits)
    max_bucket = int(jnp.max(bucket_counts))  # the one host sync
    steps = max(1, int(max_bucket).bit_length())
    packed = max_bucket < 16 and size < (1 << 27)
    table = _prefix_table_dev(bucket_counts, packed)
    return LibraryIndex(words, table, k, bits, steps, packed)


def build_library_index(lib_codes_u64: np.ndarray, k: int,
                        bits: int | None = None) -> LibraryIndex:
    """Build the device index for a sorted host library."""
    words = library_device_words(lib_codes_u64, k)
    size = len(lib_codes_u64)
    if bits is None:
        bits = _index_bits(size, k)
    bits = min(bits, 2 * k)
    # host-side prefix (no D2H of a device prefix); identical to
    # _code_prefix on the device words
    shift = max(2 * k, bits) - bits
    host_prefix = (
        (lib_codes_u64.astype(np.uint64) >> np.uint64(shift))
        & np.uint64((1 << bits) - 1)
    ).astype(np.uint32)
    bounds = np.searchsorted(
        host_prefix,
        np.arange((1 << bits) + 1, dtype=np.uint32),
    ).astype(np.int64)
    max_bucket = int((bounds[1:] - bounds[:-1]).max()) if size else 0
    steps = max(1, int(max_bucket).bit_length())
    # packed (start, len) single-gather form when both fields fit a u32
    packed = max_bucket < 16 and size < (1 << 27)
    if packed:
        table = jnp.asarray(
            ((bounds[:-1] << 4) | (bounds[1:] - bounds[:-1])).astype(np.uint32)
        )
    else:
        table = jnp.asarray(bounds.astype(np.int32))
    return LibraryIndex(words, table, k, bits, steps, packed)


def _searchsorted_words(lib_words: tuple, q_words: tuple) -> jax.Array:
    """Lower-bound index of each query in the lexicographically sorted
    word-tuple library. Single-word: native searchsorted; two-word: fixed
    log2(L)-step vectorized binary search."""
    lib_size = lib_words[0].shape[0]
    if len(lib_words) == 1:
        return jnp.searchsorted(lib_words[0], q_words[0]).astype(jnp.int32)
    lo = jnp.zeros(q_words[0].shape, jnp.int32)
    hi = jnp.full(q_words[0].shape, lib_size, jnp.int32)
    for _ in range(max(1, int(lib_size).bit_length() + 1)):
        active = lo < hi
        mid = jnp.clip((lo + hi) >> 1, 0, lib_size - 1)
        mid_words = tuple(w[mid] for w in lib_words)
        less = words_less(mid_words, q_words) & active
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where((~less) & active, mid, hi)
    return lo


def _table_lookup(lib_words: tuple, table: jax.Array, canon: tuple,
                  k: int, bits: int, steps: int,
                  packed: bool = False) -> jax.Array:
    """Prefix-table gather + fixed-step in-bucket binary search."""
    lib_size = lib_words[0].shape[0]
    q_prefix = _code_prefix(canon, k, bits)
    if packed:
        entry = table[q_prefix]
        lo = (entry >> jnp.uint32(4)).astype(jnp.int32)
        hi = lo + (entry & jnp.uint32(15)).astype(jnp.int32)
    else:
        lo = table[q_prefix]
        hi = table[q_prefix + jnp.uint32(1)]
    for _ in range(steps):
        active = lo < hi
        mid = jnp.clip((lo + hi) >> 1, 0, lib_size - 1)
        mid_words = tuple(w[mid] for w in lib_words)
        less = words_less(mid_words, canon) & active
        lo = jnp.where(less, mid + 1, lo)
        hi = jnp.where((~less) & active, mid, hi)
    return lo


def _sort_rows(planes: tuple) -> tuple:
    """Row-wise sort of strand-packed code planes (all planes are keys, so
    equal (code, strand) pairs land adjacent for dedup)."""
    if len(planes) == 1:
        return (jnp.sort(planes[0], axis=1),)
    return tuple(jax.lax.sort(planes, dimension=1, num_keys=len(planes)))


# Column width of the blocked-selection sort (stage_candidates): a
# (R*G, 1024) block sort + per-block cap slice + narrow re-sort replaces
# the full (R, W) row sort — only ~p*W of the W slots survive the sampling
# mask, so sorting the full width is O(W log W) on dead slots (the
# reference's analogue is O(bases) hash probes, kmer_searcher.cpp:308-349).
SELECT_BLOCK = 1024


def selection_cap(fraction: float, block: int = SELECT_BLOCK) -> int:
    """Per-block survivor cap: sampling mean + 6 sigma over one block.
    Poisson-ish occupancy => a block overflowing its cap is ~never for
    non-repetitive reads; overflow is counted and warned like the global
    buffer."""
    mean = fraction * block
    return max(8, int(mean + 6.0 * mean ** 0.5) + 1)


@functools.partial(
    jax.jit, static_argnames=("k", "hit_buffer", "keep_all", "block_cap")
)
def stage_candidates(bases, k, hit_buffer, keep_all, seed32, threshold,
                     block_cap=None):
    """Shared candidate-extraction stage: canonical windows + sampling-hash
    filter + candidate selection + ONE narrow row sort of the strand-packed
    codes. Computed once and consumed by both the count and the embed
    stages.

    block_cap (static, from selection_cap(fraction)) enables the blocked
    selection path: the masked planes are sorted in SELECT_BLOCK-wide
    column blocks (candidates sort to each block's front — one short sort
    instead of a full-width one), each block keeps its first block_cap
    columns, and only the (R, G*block_cap) survivor buffer pays the
    all-planes dedup sort. None (or keep_all, or narrow W) = the original
    full-width sort.

    Returns (planes, n_dropped): planes is the strand-packed
    (codec.pack_strand) word-plane tuple, each (R, width) uint32 with
    width = hit_buffer (full sort) or min(hit_buffer, G*block_cap)
    (blocked), rows sorted ascending with the all-ones sentinel on padding
    — duplicates are KEPT (multiplicity counting needs occurrences; the
    embed path dedups by adjacency). n_dropped (R,) int32 counts candidate
    occurrences beyond the staged buffer (blocked: per-block cap overflow
    counts too)."""
    canon, is_fwd, valid = canonical_window_codes(bases, k)
    return select_candidates(canon, is_fwd, valid, k, hit_buffer, keep_all,
                             seed32, threshold, block_cap)


def select_candidates(canon, is_fwd, valid, k, hit_buffer, keep_all, seed32,
                      threshold, block_cap=None):
    """Sampling filter + blocked selection + narrow dedup sort over
    precomputed canonical window codes (the post-codec half of
    stage_candidates; the packed-codec fast path feeds it directly)."""
    from fedrann_jax.kmers.codec import sample_hash32

    r, w = valid.shape
    if keep_all:
        cand = valid
    else:
        cand = valid & (sample_hash32(canon, seed32) < threshold)
    planes = pack_strand(canon, is_fwd, k)
    masked = tuple(
        jnp.where(cand, p, jnp.uint32(0xFFFFFFFF)) for p in planes
    )
    n_cand = jnp.sum(cand, axis=1).astype(jnp.int32)

    blk = SELECT_BLOCK
    if keep_all or block_cap is None or w <= 2 * blk:
        sorted_planes = _sort_rows(masked)
        staged = tuple(p[:, :hit_buffer] for p in sorted_planes)
        return staged, jnp.maximum(n_cand - hit_buffer, 0)

    g = -(-w // blk)
    pad = g * blk - w
    if pad:
        masked = tuple(
            jnp.concatenate(
                [p, jnp.full((r, pad), 0xFFFFFFFF, jnp.uint32)], axis=1
            )
            for p in masked
        )
        cand_p = jnp.concatenate([cand, jnp.zeros((r, pad), bool)], axis=1)
    else:
        cand_p = cand
    c = min(int(block_cap), blk)
    blocks = tuple(p.reshape(r * g, blk) for p in masked)
    if len(blocks) == 1:
        sel = (jnp.sort(blocks[0], axis=1),)
    else:
        # selection only: plane0 alone is the key (sentinel iff
        # non-candidate — pack_strand keeps real packed words off the
        # all-ones value for every k); full (code, strand) ordering comes
        # from the narrow sort below
        sel = tuple(jax.lax.sort(blocks, dimension=1, num_keys=1))
    narrow = tuple(p[:, :c].reshape(r, g * c) for p in sel)
    sorted_planes = _sort_rows(narrow)
    width = min(hit_buffer, g * c)
    staged = tuple(p[:, :width] for p in sorted_planes)
    # exact drop accounting: per-block survivors are min(count, cap); the
    # final slice keeps at most `width` of them
    cnt_blocks = cand_p.reshape(r, g, blk).sum(axis=2).astype(jnp.int32)
    survivors = jnp.sum(jnp.minimum(cnt_blocks, c), axis=1)
    staged_n = jnp.minimum(survivors, width)
    return staged, n_cand - staged_n


def staging_width(w: int, fraction: float) -> int:
    """Per-read candidate-buffer width: sampling mean + 6 sigma, rounded
    up to a multiple of 128 (one lane tile; capped at the window count).
    Every downstream membership/embed gather scales with this width, and
    gathers are per-element-bound on this platform (~8 ns/elem forced —
    bench notes), so tight sizing matters more than coarse shape classes
    (512-rounding cost up to 1.6x dead gather slots at the rung shapes).
    Occurrences are Poisson-ish for non-repetitive reads (6 sigma = never
    drops); heavily repetitive reads can exceed any fixed multiplier and
    are caught by the overflow counter + warning instead."""
    mean = fraction * w
    width = int(mean + 6.0 * mean ** 0.5) + 1
    return min(w, max(512, -(-width // 128) * 128))


@functools.partial(jax.jit, static_argnames=("k",))
def staged_codes(planes: tuple, k: int) -> tuple:
    """Canonical code word planes (strand stripped) of a staged buffer —
    the device library build consumes these (duplicates included). Jitted:
    the eager form dispatched ~5 per-op launches per chunk."""
    canon, _ = unpack_strand(planes, k)
    return canon


@functools.partial(
    jax.jit, static_argnames=("k", "bits", "steps", "packed")
)
def _read_hits_staged(planes, lib_words, table, k, bits, steps,
                      packed=False):
    """Membership over pre-staged sorted candidates -> feature rows.

    Everything after the sort is elementwise except the prefix-table
    lookup: dedup is an adjacent-equality mask (rows are sorted), and the
    output feature row keeps the staged layout (sentinel holes, no
    compaction)."""
    lib_size = lib_words[0].shape[0]
    sentinel = 2 * lib_size
    canon, is_fwd = unpack_strand(planes, k)
    valid = canon[0] != jnp.uint32(0xFFFFFFFF)
    for wd in canon[1:]:
        valid = valid & (wd != jnp.uint32(0xFFFFFFFF))
    # presence-set semantics: drop repeat occurrences of the same
    # (code, strand) pair — they are adjacent after the staging sort
    same_as_left = jnp.zeros_like(valid).at[:, 1:].set(
        functools.reduce(
            jnp.logical_and,
            [p[:, 1:] == p[:, :-1] for p in planes],
        )
    )
    uniq = valid & (~same_as_left)
    pos = _table_lookup(lib_words, table, canon, k, bits, steps, packed)
    pos_c = jnp.clip(pos, 0, max(lib_size - 1, 0))
    lib_at = tuple(wd[pos_c] for wd in lib_words)
    found = uniq & (pos < lib_size) & words_eq(lib_at, canon)
    feat = jnp.where(
        found,
        jnp.where(is_fwd, pos_c, pos_c + lib_size),
        sentinel,
    ).astype(jnp.int32)
    return feat, jnp.sum(found, axis=1).astype(jnp.int32)


def read_hits_staged(staged, lib: "LibraryIndex", k: int):
    """Forward-scan feature rows from staged candidates (stage_candidates
    output).

    Returns (hits, n_hits, n_dropped): hits (R, W_staged) int32 feature
    indices with sentinel (2L) holes — sentinel-padded but NOT compacted
    and NOT feature-sorted (downstream consumers are order-insensitive);
    n_hits (R,) real entries; n_dropped (R,) candidate occurrences that
    overflowed the staging buffer. Any per-read hit cap applies at staging
    time (the buffer width — read_hits' max_hits); by this point the
    buffer is fixed."""
    planes, pre_dropped = staged
    if lib.words[0].shape[0] == 0:
        r, w = planes[0].shape
        # sentinel for an empty library is 2*0 = 0; rows embed as zeros
        return (jnp.zeros((r, w), jnp.int32),
                jnp.zeros((r,), jnp.int32), pre_dropped)
    hits, n_hits = _read_hits_staged(
        planes, lib.words, lib.table, k, lib.bits, lib.steps,
        getattr(lib, "packed", False),
    )
    return hits, n_hits, pre_dropped


def read_hits(
    bases: jax.Array,            # (R, L_read) uint8
    lib,                         # word-plane tuple OR LibraryIndex
    k: int,
    max_hits: int | None = None,
    hit_buffer: int | None = None,
    sampling: tuple | None = None,
):
    """Forward-scan feature rows for a bucket of reads (staging + lookup in
    one call — the pipeline stages once and calls read_hits_staged).

    `lib` is either the uint32 word-plane tuple (plain binary search) or a
    LibraryIndex (prefix-table fast path). `sampling=(seed, fraction)`
    enables the hash prefilter — ONLY valid when the library was sampled
    with exactly that seed/fraction (fedrann_jax sampling contract); it is
    an exact optimization in that case and wrong otherwise.

    max_hits caps the staging-buffer width (candidate hit occurrences kept
    per read); occurrences beyond it are counted in n_dropped. None = no
    cap beyond the auto staging width.

    Returns:
      hits      (R, W_staged) int32, sentinel-padded (2L), unordered
      n_hits    (R,) int32 number of real entries
      n_dropped (R,) int32 candidate occurrences beyond the staging buffer
    """
    w = bases.shape[1] - k + 1
    prefilter = sampling is not None and float(sampling[1]) < 1.0
    if hit_buffer is None:
        hit_buffer = w if not prefilter else staging_width(
            w, float(sampling[1])
        )
    if max_hits is not None:
        hit_buffer = min(int(hit_buffer), max(1, int(max_hits)))
    hit_buffer = min(w, max(8, -(-int(hit_buffer) // 8) * 8))
    if prefilter:
        seed32 = jnp.uint32(np.uint32(int(sampling[0]) & 0xFFFFFFFF))
        threshold = jnp.uint32(
            min(int(float(sampling[1]) * 2.0**32), 2**32 - 1)
        )
        block_cap = selection_cap(float(sampling[1]))
    else:
        seed32 = jnp.uint32(0)
        threshold = jnp.uint32(0)
        block_cap = None
    staged = stage_candidates(
        bases, k, hit_buffer, not prefilter, seed32, threshold,
        block_cap=block_cap,
    )
    if isinstance(lib, LibraryIndex):
        return read_hits_staged(staged, lib, k)
    # raw word-plane tuple: plain binary search (test/fallback path)
    planes, pre_dropped = staged
    if lib[0].shape[0] == 0:
        r, wq = planes[0].shape
        return (jnp.zeros((r, wq), jnp.int32),
                jnp.zeros((r,), jnp.int32), pre_dropped)
    hits, n_hits = _read_hits_plain(planes, lib, k)
    return hits, n_hits, pre_dropped


@functools.partial(jax.jit, static_argnames=("k",))
def _read_hits_plain(planes, lib_words, k):
    lib_size = lib_words[0].shape[0]
    sentinel = 2 * lib_size
    canon, is_fwd = unpack_strand(planes, k)
    valid = canon[0] != jnp.uint32(0xFFFFFFFF)
    for wd in canon[1:]:
        valid = valid & (wd != jnp.uint32(0xFFFFFFFF))
    same_as_left = jnp.zeros_like(valid).at[:, 1:].set(
        functools.reduce(
            jnp.logical_and,
            [p[:, 1:] == p[:, :-1] for p in planes],
        )
    )
    uniq = valid & (~same_as_left)
    pos = _searchsorted_words(lib_words, canon)
    pos_c = jnp.clip(pos, 0, max(lib_size - 1, 0))
    lib_at = tuple(wd[pos_c] for wd in lib_words)
    found = uniq & (pos < lib_size) & words_eq(lib_at, canon)
    feat = jnp.where(
        found,
        jnp.where(is_fwd, pos_c, pos_c + lib_size),
        sentinel,
    ).astype(jnp.int32)
    return feat, jnp.sum(found, axis=1).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("lib_size",))
def mirror_hits(hits: jax.Array, lib_size: int) -> jax.Array:
    """Reverse-complement row via the i <-> i+L index mirror; padding
    (sentinel 2L) is preserved."""
    sentinel = 2 * lib_size
    return jnp.where(
        hits >= sentinel,
        sentinel,
        jnp.where(hits < lib_size, hits + lib_size, hits - lib_size),
    )
