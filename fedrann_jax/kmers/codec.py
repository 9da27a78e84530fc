"""Device k-mer codec: 2-bit window codes, reverse complement, canonical form.

Device replacement for the reference's sliding-window scanner
(kmer_searcher.cpp:308-349, kmer_to_int :138-151) and for jellyfish's
canonical (-C) coding plus the explicit reverse-complement library
(count_kmers.py:80-139): canonicalization is a bit trick, so no second
library or second scan ever exists.

Representation: k-mer codes are **uint32 word tuples** — one word (lo,)
for k <= 16, two words (hi, lo) for 17 <= k <= 31, compared
lexicographically — so device code works on 32-bit words only. uint64
appears only host-side (numpy).

All functions are jittable with static k (compile-time-unrolled rolling
accumulation; no data-dependent control flow).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_GOLDEN = jnp.uint64(0x9E3779B97F4A7C15)

# Invalid-window / padding sentinel: all-ones words. Unreachable by any
# canonical code: canon = min(code, revcomp), and an all-T window (code all
# ones in its 2k bits) has an all-A revcomp (canon 0); bits above 2k are
# always zero for real codes.
WORD_SENTINEL = np.uint32(0xFFFFFFFF)


def n_words(k: int) -> int:
    return 1 if k <= 16 else 2


def fmix32(x: jax.Array) -> jax.Array:
    """murmur3 finalizer; bitwise-identical to oracle.fmix32 (numpy)."""
    x = x.astype(jnp.uint32)
    x = x ^ (x >> jnp.uint32(16))
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> jnp.uint32(13))
    x = x * jnp.uint32(0xC2B2AE35)
    return x ^ (x >> jnp.uint32(16))


def sample_hash32(words: tuple, seed: int) -> jax.Array:
    """Device twin of oracle.sample_hash32: uint32 library-sampling hash
    over canonical-code word tuples ((lo,) or (hi, lo))."""
    if len(words) == 1:
        hi, lo = None, words[0]
    else:
        hi, lo = words
    s1 = fmix32(jnp.asarray(seed).astype(jnp.uint32))
    s2 = fmix32(s1 ^ jnp.uint32(0x9E3779B9))
    h1 = fmix32(lo ^ s1)
    h2 = fmix32((jnp.uint32(0) if hi is None else hi) ^ s2 ^ h1)
    return fmix32(h1 ^ h2)


def splitmix64(x: jax.Array) -> jax.Array:
    """uint64 mixer; bitwise-identical to oracle.splitmix64 (numpy). Used
    only in small/off-hot-path device code (SRP generation)."""
    x = x.astype(jnp.uint64)
    z = x + _GOLDEN
    z = (z ^ (z >> jnp.uint64(30))) * jnp.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> jnp.uint64(27))) * jnp.uint64(0x94D049BB133111EB)
    return z ^ (z >> jnp.uint64(31))


# --- host-side word packing -------------------------------------------------

def words_to_u64(words: tuple[np.ndarray, ...]) -> np.ndarray:
    """(hi, lo) or (lo,) uint32 host arrays -> uint64 codes."""
    if len(words) == 1:
        return words[0].astype(np.uint64)
    hi, lo = words
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def u64_to_words(codes: np.ndarray, k: int) -> tuple[np.ndarray, ...]:
    """uint64 host codes -> uint32 word tuple matching n_words(k)."""
    codes = np.asarray(codes, dtype=np.uint64)
    lo = (codes & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    if k <= 16:
        return (lo,)
    hi = (codes >> np.uint64(32)).astype(np.uint32)
    return (hi, lo)


# --- word-tuple comparisons (device) ---------------------------------------

def words_less(a: tuple, b: tuple):
    """Lexicographic a < b for equal-length uint32 word tuples."""
    if len(a) == 1:
        return a[0] < b[0]
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def words_leq(a: tuple, b: tuple):
    if len(a) == 1:
        return a[0] <= b[0]
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))


def words_eq(a: tuple, b: tuple):
    eq = a[0] == b[0]
    for x, y in zip(a[1:], b[1:]):
        eq = eq & (x == y)
    return eq


def words_select(pred, a: tuple, b: tuple) -> tuple:
    return tuple(jnp.where(pred, x, y) for x, y in zip(a, b))


def words_min(a: tuple, b: tuple) -> tuple:
    return words_select(words_less(a, b), a, b)


# --- window codes -----------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("length",))
def unpack_bases(packed: jax.Array, valid_bits: jax.Array, length: int
                 ) -> jax.Array:
    """Device unpack of the bit-packed read representation
    (native/fastxpack.cpp fastx_fill_bucket_packed): packed (R, ceil(L/4))
    holds 4 bases/byte, valid_bits (R, ceil(L/8)) 1 bit/base. Returns the
    standard (R, L) uint8 code matrix (invalid/padding -> 4). Uploading the
    packed form shrinks host->device traffic ~3.6x."""
    x = jnp.repeat(packed, 4, axis=1)[:, :length]
    shifts = jnp.tile(
        jnp.arange(0, 8, 2, dtype=jnp.uint8), packed.shape[1]
    )[:length]
    codes = (x >> shifts[None, :]) & jnp.uint8(3)
    v = jnp.repeat(valid_bits, 8, axis=1)[:, :length]
    vshifts = jnp.tile(
        jnp.arange(8, dtype=jnp.uint8), valid_bits.shape[1]
    )[:length]
    ok = ((v >> vshifts[None, :]) & jnp.uint8(1)) == 1
    return jnp.where(ok, codes, jnp.uint8(4))


@functools.partial(jax.jit, static_argnames=("length",))
def unpack_bases_len(packed: jax.Array, lengths: jax.Array, length: int
                     ) -> jax.Array:
    """Device unpack of the bit-packed reads when validity is a pure
    prefix (no mid-read N bases): the (R, ceil(L/8)) valid-bits plane —
    a third of the upload — is replaced by per-row lengths (R,) int32.
    Rows with in-read invalid bases take the unpack_bases path instead
    (pipeline._stage_chunks decides per bucket)."""
    x = jnp.repeat(packed, 4, axis=1)[:, :length]
    shifts = jnp.tile(
        jnp.arange(0, 8, 2, dtype=jnp.uint8), packed.shape[1]
    )[:length]
    codes = (x >> shifts[None, :]) & jnp.uint8(3)
    col = jax.lax.broadcasted_iota(jnp.int32, (packed.shape[0], length), 1)
    ok = col < jnp.minimum(lengths, jnp.int32(length))[:, None]
    return jnp.where(ok, codes, jnp.uint8(4))


@functools.partial(jax.jit, static_argnames=("k",))
def window_codes(bases: jax.Array, k: int):
    """All k-windows of a (R, L) uint8 base-code batch.

    Returns (code, rc, valid):
      code  tuple of (R, L-k+1) uint32 words, forward 2-bit codes
      rc    tuple of (R, L-k+1) uint32 words, reverse-complement codes
      valid (R, L-k+1) bool — window contains only A/C/G/T bases

    Invalid windows are NOT sentinel-marked here (see canonical_window_codes);
    consume `valid`.
    """
    r, length = bases.shape
    if length < k:
        raise ValueError(f"bucket length {length} < k={k}")
    w = length - k + 1
    two_words = k > 16

    lo = jnp.zeros((r, w), dtype=jnp.uint32)
    hi = jnp.zeros((r, w), dtype=jnp.uint32) if two_words else None
    rc_lo = jnp.zeros((r, w), dtype=jnp.uint32)
    rc_hi = jnp.zeros((r, w), dtype=jnp.uint32) if two_words else None
    valid = jnp.ones((r, w), dtype=bool)

    for j in range(k):  # static unroll (u32 ops compile fast; fori is slower)
        b = bases[:, j : j + w]
        ok = b < 4
        v = jnp.where(ok, b, 0).astype(jnp.uint32)
        valid = valid & ok
        # code = (code << 2) | v   across the word boundary
        if two_words:
            hi = (hi << jnp.uint32(2)) | (lo >> jnp.uint32(30))
        lo = (lo << jnp.uint32(2)) | v
        # rc |= complement(v) << 2j  (complement = v ^ 0b11)
        # shift is even and c is 2 bits wide, so a word straddle never occurs
        c = v ^ jnp.uint32(3)
        shift = 2 * j
        if shift < 32:
            rc_lo = rc_lo | (c << jnp.uint32(shift))
        else:
            rc_hi = rc_hi | (c << jnp.uint32(shift - 32))
    if two_words:
        # mask hi to the used bit width (2k - 32 bits)
        hi = hi & jnp.uint32((1 << (2 * k - 32)) - 1)
        code = (hi, lo)
        rc = (rc_hi, rc_lo)
    else:
        if 2 * k < 32:
            lo = lo & jnp.uint32((1 << (2 * k)) - 1)
        code = (lo,)
        rc = (rc_lo,)
    return code, rc, valid


def _pairrev32(x: jax.Array) -> jax.Array:
    """Reverse the order of the 16 2-bit groups of a uint32 (4 butterfly
    steps; the 2-bit groups themselves stay intact)."""
    x = ((x & jnp.uint32(0x0000FFFF)) << jnp.uint32(16)) | (x >> jnp.uint32(16))
    x = ((x & jnp.uint32(0x00FF00FF)) << jnp.uint32(8)) | (
        (x >> jnp.uint32(8)) & jnp.uint32(0x00FF00FF))
    x = ((x & jnp.uint32(0x0F0F0F0F)) << jnp.uint32(4)) | (
        (x >> jnp.uint32(4)) & jnp.uint32(0x0F0F0F0F))
    x = ((x & jnp.uint32(0x33333333)) << jnp.uint32(2)) | (
        (x >> jnp.uint32(2)) & jnp.uint32(0x33333333))
    return x


@functools.partial(jax.jit, static_argnames=("k", "length"))
def canonical_window_codes_packed(words: jax.Array, lengths: jax.Array,
                                  k: int, length: int):
    """canonical_window_codes computed DIRECTLY on the 2-bit-packed read
    stream — O(1) elementwise passes instead of the k-step rolling build.

    The k-step unrolled codec (window_codes) was measured as the single
    largest cost of the staging stage once the blocked selection landed
    (bench/micro_stage.py: 85-128 ms/chunk vs 54-69 ms for the selection
    sort at the rung shapes — it updates 3-5 (R, W) planes per base step).
    The packed form makes the whole extraction O(1) passes: the native
    packer (fastxpack.cpp fastx_fill_bucket_packed) stores base j at bits
    2*(j%4) of byte j/4, so a little-endian uint32 view of the row IS the
    2-bit LSB-first base stream. For the k-window at base i with
    v = stream bits [2i, 2i+2k):

      rc   = ~v & mask          (complement of the LSB-first value IS the
                                 MSB-first reverse-complement code)
      code = pairrev(v) >> (64-2k)   (reversing the 2-bit groups turns
                                 LSB-first into the MSB-first forward code)

    v itself comes from two (three for k > 16) word-expanded shift/or
    passes, and pairrev is 4 butterfly steps — ~20 elementwise ops total,
    independent of k.

    words: (R, ceil(length/16)) uint32 little-endian view of the packed
    bases. lengths: (R,) int32 valid-prefix lengths (this path serves the
    prefix-valid buckets; mid-read-N buckets use the unpacked codec).
    length: the bucket's base count (static). Returns (canon, is_fwd,
    valid) with the exact canonical_window_codes contract.
    """
    r, nw = words.shape
    w = length - k + 1
    two_words = k > 16
    need = nw + (2 if two_words else 1)
    ww = jnp.concatenate(
        [words, jnp.zeros((r, need - nw), jnp.uint32)], axis=1)
    # word q = i >> 4 holds bases [16q, 16q+16); expanding each word 16x
    # puts word i>>4 at column i
    exp = jnp.repeat(ww, 16, axis=1)
    w0 = exp[:, :w]
    w1 = exp[:, 16 : w + 16]
    s = 2 * (jax.lax.broadcasted_iota(jnp.uint32, (1, w), 1) & jnp.uint32(15))
    # (x >> 32) is undefined; route the s == 0 case through a select
    up = jnp.where(s == 0, jnp.uint32(0), w1 << (jnp.uint32(32) - s))
    v_lo = (w0 >> s) | up
    if not two_words:
        mask = jnp.uint32((1 << (2 * k)) - 1) if 2 * k < 32 \
            else jnp.uint32(0xFFFFFFFF)
        v = v_lo & mask
        code = (_pairrev32(v_lo) >> jnp.uint32(32 - 2 * k)) if 2 * k < 32 \
            else _pairrev32(v_lo)
        rc = (~v) & mask
        canon = (jnp.where(code <= rc, code, rc),)
        is_fwd = code <= rc
    else:
        w2 = exp[:, 32 : w + 32]
        up2 = jnp.where(s == 0, jnp.uint32(0), w2 << (jnp.uint32(32) - s))
        hmask = jnp.uint32((1 << (2 * k - 32)) - 1)
        v_hi = ((w1 >> s) | up2) & hmask
        # full 64-bit pair-reversal of (v_hi << 32 | v_lo), then >> (64-2k)
        p_lo = _pairrev32(v_lo)
        p_hi = _pairrev32(v_hi)
        sh = jnp.uint32(64 - 2 * k)  # in [2, 30] for 17 <= k <= 31
        code_hi = p_lo >> sh
        code_lo = (p_hi >> sh) | (p_lo << (jnp.uint32(32) - sh))
        rc_hi = (~v_hi) & hmask
        rc_lo = ~v_lo
        code = (code_hi, code_lo)
        rcw = (rc_hi, rc_lo)
        is_fwd = words_leq(code, rcw)
        canon = words_min(code, rcw)
    valid = (jax.lax.broadcasted_iota(jnp.int32, (r, w), 1)
             < (lengths.astype(jnp.int32) - jnp.int32(k - 1))[:, None])
    sent = jnp.uint32(0xFFFFFFFF)
    canon = tuple(jnp.where(valid, wrd, sent) for wrd in canon)
    return canon, is_fwd, valid


def pack_strand(canon: tuple, is_fwd: jax.Array, k: int) -> tuple:
    """Pack the strand bit INTO the code words so ONE sort key plane (two
    for k > 16) carries (code, is_fwd) — sorting and deduplicating staged
    candidates then needs no separate payload plane. Layout:
      k <= 15:        ((code << 1) | is_fwd,)           [2k+1 <= 31 bits]
      k == 16:        (code, is_fwd)                    [no spare bit: two planes]
      17 <= k <= 31:  ((hi << 1) | is_fwd, lo)          [2k-32+1 <= 31 bits]
    The all-ones sentinel stays all-ones (real packed words never reach it:
    the top bit is always 0 for k <= 15 / the hi plane). Ordering is NOT
    code order for two-word packs — only grouping of equal (code, strand)
    pairs is guaranteed, which is all dedup needs."""
    fwd_bit = is_fwd.astype(jnp.uint32)
    sent = canon[0] == jnp.uint32(0xFFFFFFFF)
    for w in canon[1:]:
        sent = sent & (w == jnp.uint32(0xFFFFFFFF))
    if len(canon) == 1:
        if 2 * k + 1 > 32:
            # k == 16: strand rides a second plane; force it to the sentinel
            # value on invalid windows so they sort last under both keys
            return (canon[0],
                    jnp.where(sent, jnp.uint32(0xFFFFFFFF), fwd_bit))
        packed = (canon[0] << jnp.uint32(1)) | fwd_bit
        return (jnp.where(sent, jnp.uint32(0xFFFFFFFF), packed),)
    hi, lo = canon
    packed_hi = (hi << jnp.uint32(1)) | fwd_bit
    return (jnp.where(sent, jnp.uint32(0xFFFFFFFF), packed_hi), lo)


def unpack_strand(planes: tuple, k: int) -> tuple[tuple, jax.Array]:
    """Inverse of pack_strand: (canon word tuple, is_fwd bool). Sentinel
    words stay sentinel (is_fwd is meaningless there)."""
    if len(planes) == 1:
        sent = planes[0] == jnp.uint32(0xFFFFFFFF)
        is_fwd = (planes[0] & jnp.uint32(1)) == jnp.uint32(1)
        code = planes[0] >> jnp.uint32(1)
        return (jnp.where(sent, jnp.uint32(0xFFFFFFFF), code),), is_fwd
    a, b = planes
    if k == 16:
        return (a,), b == jnp.uint32(1)
    sent = (a == jnp.uint32(0xFFFFFFFF)) & (b == jnp.uint32(0xFFFFFFFF))
    is_fwd = (a & jnp.uint32(1)) == jnp.uint32(1)
    hi = a >> jnp.uint32(1)
    return (jnp.where(sent, jnp.uint32(0xFFFFFFFF), hi), b), is_fwd


@functools.partial(jax.jit, static_argnames=("k",))
def canonical_window_codes(bases: jax.Array, k: int):
    """Canonical (min(code, revcomp)) codes of all valid windows.

    Returns (canon, is_fwd, valid): canon is a uint32 word tuple with
    all-ones WORD_SENTINEL where invalid; is_fwd = read-strand code equals
    the canonical form (palindromes count as forward — SURVEY.md §2.5
    item 3 resolution).
    """
    code, rc, valid = window_codes(bases, k)
    is_fwd = words_leq(code, rc)
    canon = words_min(code, rc)
    sent = tuple(jnp.uint32(0xFFFFFFFF) for _ in canon)
    canon = tuple(jnp.where(valid, wrd, s) for wrd, s in zip(canon, sent))
    return canon, is_fwd, valid
