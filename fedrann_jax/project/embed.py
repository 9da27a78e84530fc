"""Embedding: padded hit rows -> dense float32 read embeddings.

Replaces the reference's chunked scipy spMM over a shared-memory process
pool (feature_extraction.py:167-292). Binary presence rows times P collapse
to an embedding-table lookup: E[r] = sum_{f in hits(r)} P[f, :]. The
sentinel feature (2L) indexes P's trailing zero row, so padding contributes
nothing and zero-hit reads yield exact zero vectors (fixing the reference's
skipped-row hazard, feature_extraction.py:188-189).

The gather-accumulate runs as a lax.scan over fixed-width hit slices so peak
memory is R x hit_chunk x d instead of R x max_hits x d.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnames=("lib_size",))
def swap_halves(p_ext: jax.Array, lib_size: int) -> jax.Array:
    """P with the fwd/rev feature halves exchanged. Because the
    reverse-complement row mirrors indices i <-> i+L (membership.mirror_hits),
    E_rev[r] = sum_{f in hits} P[mirror(f)] = sum_{f in hits} P_swapped[f]:
    the rev embedding reuses the FORWARD hit rows directly — no second sort,
    and both orientations share one gather pass (embed_hits_pair)."""
    return jnp.concatenate(
        [p_ext[lib_size : 2 * lib_size], p_ext[:lib_size], p_ext[2 * lib_size :]]
    )


@functools.partial(jax.jit, static_argnames=("lib_size", "hit_chunk"))
def embed_hits_paired(
    hits: jax.Array, p_pair: jax.Array, lib_size: int,
    hit_chunk: int = 128,
) -> tuple[jax.Array, jax.Array]:
    """(fwd, rev) embeddings from the PAIRED projection table
    (srp.build_precompute_paired): ONE 2d-wide row gather per staged slot.

    Fetching a hit's forward row AND its mirror's row as one 2d-wide row
    halves the gather count for the same bytes, and unlike the
    [P | P_swapped] concat it costs no extra device memory (p_pair is the
    same table, re-laid-out), so it applies at every library size.

    Index map: hit f < L gathers p_pair[f] = [P[f] | P[f+L]] directly; a
    rev-feature hit f >= L gathers p_pair[f - L] = [P[f-L] | P[f]] with
    halves logically swapped; the sentinel 2L maps to the zero row L.
    The swap is applied in the SUM/DIFFERENCE basis so no select ever
    touches the gathered tile: with u = g_left + g_right and
    v = +-(g_left - g_right) (sign = -1 for swapped slots),
    fwd = (U + V)/2 and rev = (U - V)/2 where U, V are the f32 sums."""
    r, h = hits.shape
    d2 = p_pair.shape[1]
    d = d2 // 2
    sentinel = 2 * lib_size
    pad = (-h) % hit_chunk
    if pad:
        hits = jnp.concatenate(
            [hits, jnp.full((r, pad), sentinel, dtype=hits.dtype)], axis=1
        )
    n_chunks = hits.shape[1] // hit_chunk
    blocks = hits.reshape(r, n_chunks, hit_chunk).transpose(1, 0, 2)
    j_blocks = jnp.where(blocks >= lib_size, blocks - lib_size, blocks)
    swap_blocks = blocks >= lib_size

    def body(carry, args):
        u_acc, v_acc = carry
        jb, sb = args
        g = jnp.take(p_pair, jb, axis=0)
        gl, gr = g[..., :d], g[..., d:]
        sign = jnp.where(sb[..., None], -jnp.ones((), g.dtype),
                         jnp.ones((), g.dtype))
        u_acc = u_acc + jnp.sum(gl + gr, axis=1, dtype=jnp.float32)
        v_acc = v_acc + jnp.sum((gl - gr) * sign, axis=1, dtype=jnp.float32)
        return (u_acc, v_acc), None

    zeros = jnp.zeros((r, d), jnp.float32)
    (u, v), _ = jax.lax.scan(body, (zeros, zeros), (j_blocks, swap_blocks))
    return (u + v) * 0.5, (u - v) * 0.5


@functools.partial(jax.jit, static_argnames=("lib_size", "hit_chunk"))
def embed_hits_pair_mirror(
    hits: jax.Array, p_ext: jax.Array, lib_size: int,
    hit_chunk: int = 128,
) -> tuple[jax.Array, jax.Array]:
    """(fwd, rev) embeddings from ONE projection table.

    The reverse row is the index mirror i <-> i+L (membership.mirror_hits,
    reference feature_extraction.py:137-140), so instead of materializing
    a swapped COPY of P (9.2 GB at the chr1 rung's 2.26M-k-mer library —
    doubling P OOMs the chip), the mirror is applied to the INDICES:
    small libraries still build the one-gather-per-slot concatenated
    [P[f] | P[mirror(f)]] table; large ones gather P twice with mirrored
    index blocks (same gather count as the old two-table path, zero extra
    HBM)."""
    r, h = hits.shape
    d = p_ext.shape[1]
    n_rows = p_ext.shape[0]  # 2L + 1
    sentinel = n_rows - 1
    pad = (-h) % hit_chunk
    if pad:
        hits = jnp.concatenate(
            [hits, jnp.full((r, pad), sentinel, dtype=hits.dtype)], axis=1
        )
    n_chunks = hits.shape[1] // hit_chunk
    blocks = hits.reshape(r, n_chunks, hit_chunk).transpose(1, 0, 2)

    def mirror(b):
        return jnp.where(
            b >= sentinel, sentinel,
            jnp.where(b < lib_size, b + lib_size, b - lib_size),
        )

    if n_rows * 2 * d * p_ext.dtype.itemsize <= (1 << 30):
        perm = jnp.concatenate([
            jnp.arange(lib_size, 2 * lib_size, dtype=jnp.int32),
            jnp.arange(0, lib_size, dtype=jnp.int32),
            jnp.full((1,), 2 * lib_size, jnp.int32),
        ])
        p_cat = jnp.concatenate([p_ext, p_ext[perm]], axis=1)

        def body(acc, block):
            g = jnp.take(p_cat, block, axis=0).astype(jnp.float32)
            return acc + g.sum(axis=1), None

        acc, _ = jax.lax.scan(
            body, jnp.zeros((r, 2 * d), jnp.float32), blocks
        )
        return acc[:, :d], acc[:, d:]

    def body2(carry, block):
        acc_f, acc_r = carry
        gf = jnp.take(p_ext, block, axis=0).astype(jnp.float32)
        gr = jnp.take(p_ext, mirror(block), axis=0).astype(jnp.float32)
        return (acc_f + gf.sum(axis=1), acc_r + gr.sum(axis=1)), None

    init = (jnp.zeros((r, d), jnp.float32), jnp.zeros((r, d), jnp.float32))
    (acc_f, acc_r), _ = jax.lax.scan(body2, init, blocks)
    return acc_f, acc_r


@functools.partial(jax.jit, static_argnames=("hit_chunk",))
def embed_hits_pair(
    hits: jax.Array, p_ext: jax.Array, p_swapped: jax.Array,
    hit_chunk: int = 128,
) -> tuple[jax.Array, jax.Array]:
    """(fwd, rev) embeddings from one pass over the forward hit rows.

    For small/medium libraries, gathers ONE concatenated table
    [P | P_swapped] (2L+1, 2d) instead of two d-wide tables: half the
    gathered rows at twice the width. The concat materializes a second
    copy of P, so libraries whose doubled table would exceed ~1 GB keep
    the two-table two-gather path."""
    r, h = hits.shape
    d = p_ext.shape[1]
    use_cat = p_ext.shape[0] * 2 * d * 4 <= (1 << 30)
    pad = (-h) % hit_chunk
    if pad:
        sentinel = p_ext.shape[0] - 1
        hits = jnp.concatenate(
            [hits, jnp.full((r, pad), sentinel, dtype=hits.dtype)], axis=1
        )
    n_chunks = hits.shape[1] // hit_chunk
    blocks = hits.reshape(r, n_chunks, hit_chunk).transpose(1, 0, 2)

    if use_cat:
        p_cat = jnp.concatenate([p_ext, p_swapped], axis=1)

        def body(acc, block):
            g = jnp.take(p_cat, block, axis=0).astype(jnp.float32)
            return acc + g.sum(axis=1), None

        acc, _ = jax.lax.scan(
            body, jnp.zeros((r, 2 * d), jnp.float32), blocks
        )
        return acc[:, :d], acc[:, d:]

    def body2(carry, block):
        acc_f, acc_r = carry
        acc_f = acc_f + jnp.take(p_ext, block, axis=0).sum(axis=1)
        acc_r = acc_r + jnp.take(p_swapped, block, axis=0).sum(axis=1)
        return (acc_f, acc_r), None

    init = (jnp.zeros((r, d), jnp.float32), jnp.zeros((r, d), jnp.float32))
    (acc_f, acc_r), _ = jax.lax.scan(body2, init, blocks)
    return acc_f, acc_r


@functools.partial(jax.jit, static_argnames=("hit_chunk",))
def embed_hits(hits: jax.Array, p_ext: jax.Array, hit_chunk: int = 128) -> jax.Array:
    """hits (R, H) int32 feature indices (sentinel-padded), p_ext (2L+1, d)
    -> (R, d) float32."""
    r, h = hits.shape
    d = p_ext.shape[1]
    pad = (-h) % hit_chunk
    if pad:
        sentinel = p_ext.shape[0] - 1
        hits = jnp.concatenate(
            [hits, jnp.full((r, pad), sentinel, dtype=hits.dtype)], axis=1
        )
    n_chunks = hits.shape[1] // hit_chunk
    blocks = hits.reshape(r, n_chunks, hit_chunk).transpose(1, 0, 2)

    def body(acc, block):
        return acc + jnp.take(p_ext, block, axis=0).sum(axis=1), None

    init = jnp.zeros((r, d), dtype=jnp.float32)
    acc, _ = jax.lax.scan(body, init, blocks)
    return acc


@functools.partial(jax.jit, static_argnames=("lib_size", "hit_chunk", "d"))
def embed_hits_paired_signs(
    hits: jax.Array, signs: jax.Array, mags: jax.Array, lib_size: int,
    d: int, hit_chunk: int = 128,
) -> tuple[jax.Array, jax.Array]:
    """embed_hits_paired over the 2-bit-packed ternary projection
    (srp.build_precompute_signs): per staged slot, gather a (2d/16)-wide
    uint32 sign row + one f32 magnitude instead of a 2d-wide bf16 row —
    8x less table HBM (the human rung's dense table OOM'd the chip) and
    entries reconstructed exactly in f32 (vs the dense path's bf16
    rounding). Same index/mirror semantics and the same sum/difference
    swap trick as embed_hits_paired."""
    r, h = hits.shape
    sentinel = 2 * lib_size
    pad = (-h) % hit_chunk
    if pad:
        hits = jnp.concatenate(
            [hits, jnp.full((r, pad), sentinel, dtype=hits.dtype)], axis=1
        )
    n_chunks = hits.shape[1] // hit_chunk
    blocks = hits.reshape(r, n_chunks, hit_chunk).transpose(1, 0, 2)
    j_blocks = jnp.where(blocks >= lib_size, blocks - lib_size, blocks)
    swap_blocks = blocks >= lib_size
    w = signs.shape[1]  # ceil(2d/16)

    def body(carry, args):
        u_acc, v_acc = carry
        jb, sb = args
        gp = jnp.take(signs, jb, axis=0)          # (r, hc, w) u32
        mag = jnp.take(mags, jb, axis=0)          # (r, hc) f32
        # unpack 16 2-bit fields per word -> (r, hc, 2d) f32 in {-1,0,1};
        # XLA fuses the unpack into the reductions (no full temp)
        fields = (gp[..., None] >> (2 * jnp.arange(16, dtype=jnp.uint32))) \
            & jnp.uint32(3)
        vals = ((fields == 1).astype(jnp.float32)
                - (fields == 2).astype(jnp.float32))
        vals = vals.reshape(*gp.shape[:-1], w * 16)[..., : 2 * d]
        vals = vals * mag[..., None]
        gl, gr = vals[..., :d], vals[..., d:]
        sign = jnp.where(sb[..., None], -1.0, 1.0).astype(jnp.float32)
        u_acc = u_acc + jnp.sum(gl + gr, axis=1, dtype=jnp.float32)
        v_acc = v_acc + jnp.sum((gl - gr) * sign, axis=1, dtype=jnp.float32)
        return (u_acc, v_acc), None

    zeros = jnp.zeros((r, d), jnp.float32)
    (u, v), _ = jax.lax.scan(body, (zeros, zeros), (j_blocks, swap_blocks))
    return (u + v) * 0.5, (u - v) * 0.5


def embed_hits_paired_auto(hits, p_a, p_b, lib_size: int, d: int):
    """Dispatch on the projection representation (static under jit):
    uint32 p_a = 2-bit-packed ternary signs + per-row mags (p_b), else
    p_a is the dense paired table (p_b unused)."""
    if p_a.dtype == jnp.uint32:
        return embed_hits_paired_signs(hits, p_a, p_b, lib_size, d)
    return embed_hits_paired(hits, p_a, lib_size)
