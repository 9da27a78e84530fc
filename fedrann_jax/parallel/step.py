"""The fully-sharded overlap step: packed bases in, neighbor lists out.

One jitted shard_map program over the "data" mesh axis that fuses stages
3+4 of the pipeline (membership -> embedding -> exact ring top-k). Sharding
layout (SURVEY.md §2.8):

- read bases: row-sharded (data parallel) — device m owns reads
  [m*B, (m+1)*B), hence embedding rows [2mB, 2(m+1)B) of the global
  fwd/rev-interleaved matrix,
- library words + prefix table + precompute matrix: replicated
  (seed-deterministic, so replication costs one broadcast),
- candidates: rotated around the device ring (ppermute) with a running
  top-k merge per step, or all-gathered (strategy flag).

Uses the same fast paths as the single-chip pipeline: prefix-table
membership with optional sampling prefilter, and the half-swapped-P paired
embedding. This is also the program dryrun-compiled by
__graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


from fedrann_jax.kmers.membership import (
    LibraryIndex,
    build_library_index,
    read_hits,
)
from fedrann_jax.knn.ring import _allgather_body, _ring_body
from fedrann_jax.knn.topk import normalize_rows
from fedrann_jax.parallel.mesh import DATA_AXIS, shard_map_norep
from fedrann_jax.project.embed import embed_hits_paired


def make_sharded_step(
    mesh,
    k: int,
    max_hits: int,
    n_neighbors: int,
    precision: str = "bf16",
    strategy: str = "ring",
    bits: int = 8,
    steps: int = 8,
    table_packed: bool = False,
    hit_buffer: int | None = None,
    sampling: tuple | None = None,
    n_reads: int | None = None,
):
    """Build the jitted sharded step.

    Returned fn(bases (R, L) uint8, lib (words..., table) pytree,
    p_pair (L+1, 2d) paired projection (srp.build_precompute_paired))
    -> (distances (2R, k_nn), indices (2R, k_nn)).
    R must divide by the mesh size (pad with all-INVALID rows host-side);
    pass the REAL read count as n_reads so the padding rows (embedding rows
    >= 2*n_reads) can never enter a real read's top-k and their out-of-range
    indices never reach the TSV writers (ADVICE r1). Callers slice the
    output to [:2*n_reads]. bits/steps must come from the LibraryIndex the
    inputs were built with.
    """
    n_dev = mesh.devices.size

    def body(bases_local, lib, p_pair):
        words, table = lib
        index = LibraryIndex(words, table, k, bits, steps, table_packed)
        hits, _, _ = read_hits(
            bases_local, index, k, max_hits,
            hit_buffer=hit_buffer, sampling=sampling,
        )
        lib_size = words[0].shape[0]
        e_fwd, e_rev = embed_hits_paired(hits, p_pair, lib_size)
        b = e_fwd.shape[0]
        e = jnp.stack([e_fwd, e_rev], axis=1).reshape(2 * b, e_fwd.shape[1])
        en = normalize_rows(e)
        n_real = 2 * b * n_dev if n_reads is None else 2 * n_reads
        ring = _ring_body if strategy == "ring" else _allgather_body
        dist, idx = ring(en, n_dev=n_dev, k=n_neighbors, n_real=n_real,
                         precision=precision)
        return dist, idx

    mapped = shard_map_norep(
        body,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(), P()),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None)),
    )
    return jax.jit(mapped)


def shard_step_inputs(mesh, bases, library_codes_u64: np.ndarray, k: int,
                      p_pair):
    """Build + place inputs with the shardings make_sharded_step expects
    (p_pair: the paired-layout projection, srp.build_precompute_paired).
    Returns (args tuple, index) — pass index.bits/index.steps/index.packed
    to make_sharded_step."""
    index = build_library_index(library_codes_u64, k)
    rep = NamedSharding(mesh, P())
    args = (
        jax.device_put(bases, NamedSharding(mesh, P(DATA_AXIS, None))),
        (
            tuple(jax.device_put(w, rep) for w in index.words),
            jax.device_put(index.table, rep),
        ),
        jax.device_put(p_pair, rep),
    )
    return args, index
