"""Fully device-resident k-mer library construction.

Replaces the whole jellyfish-count/dump + awk-sample + seqkit-revcomp
subshell chain (reference count_kmers.py:52-149) with ONE device program
over the concatenated canonical window stream:

  sort -> run-length boundaries -> multiplicity filter -> seeded-hash
  threshold sampling -> gather-compaction (ops.py) into a static buffer.

Rationale: the raw window stream is the largest intermediate of the
pipeline and never leaves the device. Only the compacted sampled library
(codes + counts, a few MB at most) is transferred, once.

The sampling hash is bitwise-identical to oracle.sample_mask (murmur3-style
uint32 threshold over code words), so host, device, and every chip in a
mesh reconstruct the same library from the seed with zero communication.
The stages are small separately-jitted programs rather than one fused
graph: each is simple and persistent-cache-stable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from fedrann_jax.kmers.codec import sample_hash32, words_to_u64
from fedrann_jax.logging_utils import logger
from fedrann_jax.ops import compact_flat
from fedrann_jax.oracle import KmerLibrary


class DeviceLibrary:
    """Device-resident sampled library with the KmerLibrary surface.

    The sorted word planes and counts stay device arrays end to end (no
    D2H of the library only for the embed stage to re-upload it); `.codes` /
    `.counts` materialize host copies lazily, so only consumers that
    genuinely need host data (checkpoint save, multi-host library merge,
    golden/compat comparisons) ever pay the transfer.
    """

    def __init__(self, words: tuple, counts: "jax.Array", k: int):
        self.words_dev = words          # tuple of (n,) uint32 device arrays
        self.counts_dev = counts        # (n,) int32 device array
        self.k = k
        self._codes = None
        self._counts = None

    @property
    def size(self) -> int:
        return int(self.words_dev[0].shape[0])

    @property
    def n_features(self) -> int:
        return 2 * self.size

    @property
    def codes(self) -> np.ndarray:
        if self._codes is None:
            self._codes = words_to_u64(
                tuple(np.asarray(w) for w in self.words_dev)
            )
        return self._codes

    @property
    def counts(self) -> np.ndarray:
        if self._counts is None:
            self._counts = np.asarray(self.counts_dev).astype(np.int64)
        return self._counts


@jax.jit
def _sort_words(words):
    """Lexicographic device sort of a word-plane tuple (single-word:
    jnp.sort; two-word: lax.sort with num_keys=2)."""
    flat = tuple(w.ravel() for w in words)
    if len(flat) == 1:
        return (jnp.sort(flat[0]),)
    return tuple(jax.lax.sort(flat, num_keys=2))


@functools.partial(jax.jit, static_argnames=("cap",))
def _prefilter_sampled(flat_words, cap: int, seed32, threshold):
    """Sampling-first: keep only windows whose code passes the sampling
    hash BEFORE the global sort. Sampling commutes with counting (every
    occurrence of a code shares the hash), so survivor counts are exact —
    and the expensive sort shrinks by ~1/sample_fraction."""
    keep = sample_hash32(flat_words, seed32) < threshold
    is_sent = flat_words[0] == jnp.uint32(0xFFFFFFFF)
    for w in flat_words[1:]:
        is_sent = is_sent & (w == jnp.uint32(0xFFFFFFFF))
    keep = keep & (~is_sent)
    out, n_kept, n_total = compact_flat(
        keep, flat_words, cap, (jnp.uint32(0xFFFFFFFF),) * len(flat_words)
    )
    del n_kept
    return out, n_total


@functools.partial(jax.jit, static_argnames=("min_multiplicity",))
def _keep_and_counts(sorted_words, min_multiplicity: int, seed32, threshold,
                     keep_all):
    """sorted_words: tuple of (N,) uint32 planes, lexicographically sorted,
    all-ones sentinel block on top. Returns (keep mask, group counts)."""
    n = sorted_words[0].shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)

    prev = tuple(w[:-1] for w in sorted_words)
    curr = tuple(w[1:] for w in sorted_words)
    ne = curr[0] != prev[0]
    for a, b in zip(curr[1:], prev[1:]):
        ne = ne | (a != b)
    boundary = jnp.concatenate([jnp.ones((1,), bool), ne])

    is_sentinel = sorted_words[0] == jnp.uint32(0xFFFFFFFF)
    for w in sorted_words[1:]:
        is_sentinel = is_sentinel & (w == jnp.uint32(0xFFFFFFFF))

    # run length of the group starting at p = next boundary index - p
    b_idx = jnp.where(boundary, idx, n)
    nxt = jnp.concatenate([b_idx[1:], jnp.full((1,), n, jnp.int32)])
    next_boundary = jax.lax.cummin(nxt, axis=0, reverse=True)
    count = next_boundary - idx

    hashed = sample_hash32(sorted_words, seed32)
    sampled = keep_all | (hashed < threshold)
    keep = boundary & (~is_sentinel) & (count >= min_multiplicity) & sampled
    return keep, count


@functools.partial(jax.jit, static_argnames=("cap",))
def _compact(sorted_words, keep, count, cap: int):
    nw = len(sorted_words)
    outs, _, n_total = compact_flat(
        keep, (*sorted_words, count.astype(jnp.int32)), cap,
        (*(jnp.uint32(0xFFFFFFFF),) * nw, 0),
    )
    return outs[:-1], outs[-1], n_total


def build_library_on_device(
    canon_chunks: list,
    k: int,
    min_multiplicity: int,
    sample_fraction: float,
    seed: int,
    cap: int | None = None,
    presampled: bool = False,
) -> DeviceLibrary:
    """canon_chunks: list of canonical-code word tuples (device arrays, any
    shape — flattened here), as produced by canonical_window_codes (invalid
    windows carry the all-ones sentinel). Returns a DeviceLibrary (sorted
    unique sampled codes + multiplicities, device-resident; host views are
    lazy).
    """
    n_words_ = len(canon_chunks[0])
    flat = tuple(
        jnp.concatenate([c[i].ravel() for c in canon_chunks])
        for i in range(n_words_)
    )
    total = flat[0].shape[0]
    # pad the stream to the next power of two with the all-ones sentinel:
    # shapes are then cache-stable across datasets, so the expensive sort /
    # compact programs compile once per size class, not once per run
    padded = 1 << (total - 1).bit_length()
    if padded > total:
        flat = tuple(
            jnp.concatenate(
                [w, jnp.full((padded - total,), 0xFFFFFFFF, dtype=jnp.uint32)]
            )
            for w in flat
        )
    keep_all = sample_fraction >= 1.0
    threshold = np.uint32(min(int(sample_fraction * 2.0**32), 2**32 - 1))
    seed32 = jnp.uint32(np.uint32(seed & 0xFFFFFFFF))

    if not keep_all and not presampled:
        # sampling-first: shrink the sort by ~1/sample_fraction
        # (presampled inputs — stage_candidates output — skip this pass)
        scap = min(padded, max(1024, int(2.5 * sample_fraction * padded)))
        scap = 1 << (int(scap) - 1).bit_length()
        survivors, n_surv = _prefilter_sampled(flat, scap, seed32, threshold)
        if int(n_surv) > scap:
            logger.warning(
                "sampling prefilter capacity %d overflowed (%d) — "
                "falling back to the full stream", scap, int(n_surv),
            )
        else:
            flat = survivors

    sorted_words = _sort_words(flat)
    keep, count = _keep_and_counts(
        sorted_words, min_multiplicity, seed32,
        jnp.uint32(threshold), jnp.bool_(keep_all),
    )
    # one scalar transfer buys an exactly-sized compact buffer — the library
    # D2H transfer is then proportional to the real library, not the stream
    n = int(jnp.sum(keep)) if cap is None else None
    if cap is None:
        cap = 1 << max(10, (max(n, 1) - 1).bit_length())
    else:
        cap = 1 << (int(cap) - 1).bit_length()
    lib_words, counts, n_keep = _compact(sorted_words, keep, count, cap)
    if n is None:
        # caller-capped path only: the derived-cap path above already paid
        # the scalar D2H for n (== n_keep by construction: compact_flat
        # counts the same keep mask); each scalar fetch is a host sync
        n = int(n_keep)
    if n > cap:
        logger.warning(
            "library capacity %d overflowed (%d kept) — rebuilding uncapped",
            cap, n,
        )
        lib_words, counts, n_keep = _compact(
            sorted_words, keep, count, flat[0].shape[0]
        )
    # trim on device: the library never crosses to the host here
    # (DeviceLibrary materializes .codes/.counts lazily for the few
    # consumers that need host copies)
    return DeviceLibrary(
        words=tuple(w[:n] for w in lib_words),
        counts=counts[:n].astype(jnp.int32),
        k=k,
    )
