"""Gather-based stable stream compaction.

A scatter with data-dependent indices can serialize on an accelerator,
while gathers run at memory bandwidth. Compaction (keep masked elements,
order preserved, fixed output width) is therefore reformulated
scatter-free:

  csum[r, w]   = inclusive cumsum of the keep mask
  src[r, j]    = lower_bound(csum[r, :], j+1)   (first column holding the
                 j-th kept element — binary search, log2(W) gathers)
  out[r, j]    = values[r, src[r, j]]            (one gather)

This is the workhorse under candidate staging (kmers/membership.py) and
device library construction (kmers/library_device.py). The reference has no
analogue — its compactions are hash-set inserts (kmer_searcher.cpp:309).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lower_bound_rows(csum: jax.Array, targets: jax.Array) -> jax.Array:
    """First column where the non-decreasing row csum reaches each target.

    csum (R, W) int32, targets (K,) int32 -> (R, K) int32 in [0, W]
    (W = target never reached)."""
    r, w = csum.shape
    k = targets.shape[0]
    lo = jnp.zeros((r, k), jnp.int32)
    hi = jnp.full((r, k), w, jnp.int32)
    t = jnp.broadcast_to(targets[None, :], (r, k))
    for _ in range(max(1, int(w).bit_length())):
        mid = (lo + hi) >> 1
        v = jnp.take_along_axis(csum, jnp.clip(mid, 0, w - 1), axis=1)
        go_right = v < t
        lo = jnp.where(go_right, mid + 1, lo)
        hi = jnp.where(go_right, hi, mid)
    return lo


def compact_rows(
    mask: jax.Array,
    values: tuple,
    out_width: int,
    fills: tuple,
):
    """Per-row stable compaction of masked elements, scatter-free.

    mask (R, W) bool; values: tuple of (R, W) arrays gathered at the kept
    positions; fills: per-value fill for unused output slots.

    Returns (outs tuple of (R, out_width), n_kept (R,) int32 clipped to
    out_width, n_dropped (R,) int32 kept-beyond-capacity count)."""
    r, w = mask.shape
    csum = jnp.cumsum(mask, axis=1).astype(jnp.int32)
    targets = jnp.arange(1, out_width + 1, dtype=jnp.int32)
    src = lower_bound_rows(csum, targets)
    ok = src < w
    src_c = jnp.clip(src, 0, w - 1)
    outs = tuple(
        jnp.where(ok, jnp.take_along_axis(v, src_c, axis=1),
                  jnp.asarray(f, dtype=v.dtype))
        for v, f in zip(values, fills)
    )
    n = csum[:, -1]
    return outs, jnp.minimum(n, out_width), jnp.maximum(n - out_width, 0)


def compact_flat(
    mask: jax.Array,
    values: tuple,
    cap: int,
    fills: tuple,
):
    """1-D variant: compact a flat stream to a fixed capacity.

    Returns (outs tuple of (cap,), n_kept scalar int32 clipped to cap,
    n_total scalar int32 unclipped)."""
    outs, n, dropped = compact_rows(
        mask[None, :], tuple(v[None, :] for v in values), cap, fills
    )
    return tuple(o[0] for o in outs), n[0], n[0] + dropped[0]
