"""Device-side ICF weights and sparse-random-projection precompute matrix.

Replaces the reference's scipy-sparse construction (precompute.py:58-115):
P[f, c] = ICF[f] * SRP[f, c] with entry nonzero w.p. density
(auto = 1/sqrt(n_features)), value +-sqrt(1/density)/sqrt(n_components)
(reference :80-107), ICF = log(n_features / (count + 1e-12)) shared by the
fwd/rev index halves (reference :71-77).

The SRP stream is counter-based (splitmix64 of (feature, component)), so it
is bitwise identical to oracle.srp_matrix, regenerable column-by-column
inside kernels, and trivially "replicated" across hosts: every device
derives the same matrix from the seed with zero communication (SURVEY.md
§7.3). At the reference's default density 1/sqrt(F) the matrix is sparse;
it is stored as 2-bit signs plus one magnitude per row (the default), or
dense, and the embed stage gathers its rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from fedrann_jax.kmers.codec import splitmix64, _GOLDEN


def icf_weights_device(counts: jax.Array) -> jax.Array:
    """(L,) canonical multiplicities -> (2L,) float32 ICF weights."""
    n_features = 2 * counts.shape[0]
    c = jnp.concatenate([counts, counts]).astype(jnp.float64)
    return jnp.log(n_features / (c + 1e-12)).astype(jnp.float32)


@functools.partial(
    jax.jit, static_argnames=("n_components", "density", "chunk_size")
)
def _srp_chunk(seed_mix, icf_chunk, n_components, density, chunk_start, chunk_size):
    # chunk_start is TRACED (a uint64 scalar): with it static, every chunk
    # of a large table compiled its own program (69 compiles / 12 s cold at
    # the chr1 rung); traced, the whole build is one program per
    # (chunk_size, d) pair. The iota+add produces the same uint64 feature
    # ids bitwise.
    f = (
        (jnp.arange(chunk_size, dtype=jnp.uint64)
         + jnp.asarray(chunk_start, dtype=jnp.uint64))[:, None]
        * _GOLDEN
    )
    c = jnp.arange(n_components, dtype=jnp.uint64)[None, :]
    h = splitmix64(f + c + seed_mix)
    nonzero = (h >> jnp.uint64(1)) < jnp.uint64(int(density * 2.0**63))
    sign = jnp.where((h & jnp.uint64(1)) == 1, 1.0, -1.0).astype(jnp.float32)
    scale = jnp.float32((1.0 / density) ** 0.5 / n_components**0.5)
    return nonzero * sign * scale * icf_chunk[:, None]


def build_precompute(
    counts: jax.Array,
    n_components: int,
    seed: int,
    density: float | None = None,
    chunk: int = 1 << 16,
    dtype=jnp.float32,
) -> jax.Array:
    """(2L + 1, n_components) P = SRP .* ICF with one trailing all-zero
    row for the padding sentinel (feature index 2L), so padded hit
    matrices embed with no masking. dtype=bfloat16 casts each chunk as it
    is built, so the f32 table never materializes whole (a post-hoc
    astype at the chr1 rung held 9.2 GB f32 + 4.6 GB bf16 at once and
    OOM'd the chip)."""
    icf = icf_weights_device(counts)
    n_features = icf.shape[0]
    if density is None:
        density = 1.0 / float(n_features) ** 0.5 if n_features else 1.0
    seed_mix = splitmix64(jnp.uint64(seed))
    parts = []
    for start in range(0, n_features, chunk):
        size = min(chunk, n_features - start)
        parts.append(
            _srp_chunk(seed_mix, icf[start : start + size], n_components, density,
                       start, size).astype(dtype)
        )
    zero_row = jnp.zeros((1, n_components), dtype=dtype)
    if not parts:
        return zero_row
    return jnp.concatenate(parts + [zero_row], axis=0)


def build_precompute_paired(
    counts: jax.Array,
    n_components: int,
    seed: int,
    density: float | None = None,
    chunk: int = 1 << 16,
    dtype=jnp.float32,
) -> jax.Array:
    """(L + 1, 2 * n_components) PAIRED projection layout: row j holds
    [P[j] | P[j + L]] — a feature's forward row and its mirror's row side
    by side — with a trailing all-zero sentinel row (j = L).

    Same entries, bitwise, as build_precompute; only the layout differs.
    This is the embed stage's hot format: the fwd and rev contributions of
    one staged hit live in ONE 2d-wide table row, so the gather-bound
    embed pays half the row gathers of the flat layout at identical HBM
    footprint (embed.embed_hits_paired). Built directly from the
    counter-based SRP stream, so no flat (2L+1, d) table or transient
    second copy ever materializes."""
    icf = icf_weights_device(counts)
    n_features = icf.shape[0]
    lib_size = int(counts.shape[0])
    if density is None:
        density = 1.0 / float(n_features) ** 0.5 if n_features else 1.0
    seed_mix = splitmix64(jnp.uint64(seed))
    parts = []
    for start in range(0, lib_size, chunk):
        size = min(chunk, lib_size - start)
        # ICF is shared by the fwd/rev halves (icf[j] == icf[j + L] by
        # construction), but the SRP stream is indexed by the FLAT feature
        # id, so the right half draws features [L+start, L+start+size)
        left = _srp_chunk(seed_mix, icf[start : start + size], n_components,
                          density, start, size).astype(dtype)
        right = _srp_chunk(
            seed_mix, icf[lib_size + start : lib_size + start + size],
            n_components, density, lib_size + start, size,
        ).astype(dtype)
        parts.append(jnp.concatenate([left, right], axis=1))
    zero_row = jnp.zeros((1, 2 * n_components), dtype=dtype)
    if not parts:
        return zero_row
    return jnp.concatenate(parts + [zero_row], axis=0)


def pair_projection(p_ext, xp=jnp):
    """Flat (2L+1, d) table -> paired (L+1, 2d) layout (imported /
    reference-produced tables; freshly built ones use
    build_precompute_paired and never exist flat)."""
    n_rows, d = p_ext.shape
    lib_size = (n_rows - 1) // 2
    return xp.concatenate(
        [
            xp.concatenate(
                [p_ext[:lib_size], p_ext[lib_size : 2 * lib_size]], axis=1
            ),
            xp.zeros((1, 2 * d), p_ext.dtype),
        ],
        axis=0,
    )


def build_precompute_signs(
    counts: jax.Array,
    n_components: int,
    seed: int,
    density: float | None = None,
    chunk: int = 1 << 16,
):
    """2-bit-packed PAIRED projection: (signs (L+1, 2d/16) uint32,
    mags (L+1,) float32).

    The SRP-x-ICF table factorizes exactly: every nonzero in paired row j
    is +-(scale * icf[j]) — a per-row SCALAR times a ternary sign. Packing
    the signs 16-per-uint32 (2-bit codes: 0 = zero, 1 = +1, 2 = -1)
    shrinks the embed gather table 8x vs bf16 (chr1: 4.6 GB -> 0.58 GB;
    the 2.66M-k-mer human rung's 5.4 GB table OOM'd a 16 GB chip next to
    the staged stacks) and REMOVES the bf16 rounding the dense table paid:
    the reconstructed entries are bitwise the f32 construction
    (sign * scale * icf, same splitmix64 stream as _srp_chunk).

    Same (f, c) -> (nonzero, sign) stream as build_precompute_paired; row
    j packs [P[j] | P[j+L]] column-major in 2-bit fields, sentinel row L
    is all-zero with mag 0."""
    icf = icf_weights_device(counts)
    n_features = icf.shape[0]
    lib_size = int(counts.shape[0])
    if density is None:
        density = 1.0 / float(n_features) ** 0.5 if n_features else 1.0
    seed_mix = splitmix64(jnp.uint64(seed))
    scale = jnp.float32((1.0 / density) ** 0.5 / n_components**0.5)
    parts = []
    for start in range(0, lib_size, chunk):
        size = min(chunk, lib_size - start)
        left = _srp_sign_chunk(seed_mix, n_components, density, start, size)
        right = _srp_sign_chunk(seed_mix, n_components, density,
                                lib_size + start, size)
        parts.append(_pack_signs(jnp.concatenate([left, right], axis=1)))
    zero_row = jnp.zeros((1, (2 * n_components + 15) // 16), jnp.uint32)
    if parts:
        signs = jnp.concatenate(parts + [zero_row], axis=0)
    else:
        signs = zero_row
    mags = jnp.concatenate(
        [icf[:lib_size].astype(jnp.float32) * scale,
         jnp.zeros((1,), jnp.float32)]
    )
    return signs, mags


@functools.partial(
    jax.jit, static_argnames=("n_components", "density", "chunk_size")
)
def _srp_sign_chunk(seed_mix, n_components, density, chunk_start,
                    chunk_size):
    """(chunk, d) int32 sign codes {0: zero, 1: +1, 2: -1} from the same
    counter stream as _srp_chunk (bitwise-identical nonzero/sign bits)."""
    f = (
        (jnp.arange(chunk_size, dtype=jnp.uint64)
         + jnp.asarray(chunk_start, dtype=jnp.uint64))[:, None]
        * _GOLDEN
    )
    c = jnp.arange(n_components, dtype=jnp.uint64)[None, :]
    h = splitmix64(f + c + seed_mix)
    nonzero = (h >> jnp.uint64(1)) < jnp.uint64(int(density * 2.0**63))
    pos = (h & jnp.uint64(1)) == 1
    return jnp.where(nonzero, jnp.where(pos, 1, 2), 0).astype(jnp.int32)


@jax.jit
def _pack_signs(codes: jax.Array) -> jax.Array:
    """(rows, w) 2-bit codes -> (rows, ceil(w/16)) uint32, field i at bits
    2*(i%16) of word i//16."""
    r, w = codes.shape
    pad = (-w) % 16
    if pad:
        codes = jnp.concatenate(
            [codes, jnp.zeros((r, pad), codes.dtype)], axis=1)
    grouped = codes.reshape(r, -1, 16).astype(jnp.uint32)
    shifts = (2 * jnp.arange(16, dtype=jnp.uint32))[None, None, :]
    return jnp.sum(grouped << shifts, axis=2, dtype=jnp.uint32)
