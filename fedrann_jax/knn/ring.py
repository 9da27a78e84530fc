"""Sharded exact k-NN over a device mesh: all-gather and ring variants.

The scaling story of SURVEY.md §2.8/§5: embeddings are row-sharded over the
"data" mesh axis; every device owns a query block and a candidate block.

- **allgather**: candidates are jax.lax.all_gather'ed once, each device runs
  the local tiled top-k against the full candidate set. Simple; memory
  O(N x d) per device — right for small/medium N.
- **ring**: the ring-attention-shaped variant — candidate blocks rotate
  around the device ring via jax.lax.ppermute while each device folds the
  new block's scores into a running top-k. Peak memory O(N/n_dev x d); the
  N^2 distance work streams through device-memory-sized tiles, and XLA can
  overlap the ppermute with the next block's matmul.

Both return globally-indexed neighbors identical (up to fp reduction order)
to the single-device knn_exact.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P


from fedrann_jax.knn.topk import (
    dequantize_dist,
    normalize_rows,
    quantize_dist,
    scores_nt,
    transfer_idx,
)
from fedrann_jax.parallel.mesh import (
    DATA_AXIS,
    HOST_AXIS,
    make_mesh,
    make_mesh_2d,
    shard_map_norep,
)


def _merge_topk(run_dist, run_idx, new_dist, new_idx, k):
    """Fold (B, m) new candidates into a (B, k) running top-k (min dist)."""
    dist = jnp.concatenate([run_dist, new_dist], axis=1)
    idx = jnp.concatenate([run_idx, new_idx], axis=1)
    # top_k keeps largest -> negate distances
    neg, pos = jax.lax.top_k(-dist, k)
    return -neg, jnp.take_along_axis(idx, pos, axis=1)


def _ring_body(en_local, n_dev, k, n_real, precision):
    """Runs inside shard_map. en_local: (B, d) normalized local rows."""
    b = en_local.shape[0]
    my = jax.lax.axis_index(DATA_AXIS)
    col_base = jax.lax.broadcasted_iota(jnp.int32, (1, b), 1)

    init_dist = jnp.full((b, k), jnp.inf, dtype=jnp.float32)
    init_idx = jnp.full((b, k), -1, dtype=jnp.int32)

    def step(s, carry):
        run_dist, run_idx, block = carry
        owner = (my - s) % n_dev  # whose block we hold at step s
        scores = scores_nt(en_local, block, precision)
        new_idx = col_base + owner.astype(jnp.int32) * b
        new_idx = jnp.broadcast_to(new_idx, (en_local.shape[0], b))
        # zero-padded global rows >= n_real must never win a slot
        new_dist = jnp.where(new_idx >= n_real, jnp.inf, 1.0 - scores)
        run_dist, run_idx = _merge_topk(run_dist, run_idx, new_dist, new_idx, k)
        block = jax.lax.ppermute(
            block, DATA_AXIS,
            perm=[(i, (i + 1) % n_dev) for i in range(n_dev)],
        )
        return run_dist, run_idx, block

    run_dist, run_idx, _ = jax.lax.fori_loop(
        0, n_dev, step, (init_dist, init_idx, en_local)
    )
    return run_dist, run_idx


def _allgather_body(en_local, n_dev, k, n_real, precision,
                    candidate_tile: int = 131072):
    """all_gather candidates, then a tiled scan with a running top-k: the
    full (B, N) score matrix never materializes (VERDICT r1 weak 5 — the
    untiled form was an HBM wall at multi-million-row rungs; only the
    gathered embeddings themselves are O(N x d))."""
    full = jax.lax.all_gather(en_local, DATA_AXIS, tiled=True)  # (N, d)
    n_total, d = full.shape
    b = en_local.shape[0]
    tile = min(candidate_tile, n_total)
    pad = (-n_total) % tile
    if pad:
        full = jnp.concatenate([full, jnp.zeros((pad, d), full.dtype)])
    blocks = full.reshape(-1, tile, d)
    bases = jnp.arange(blocks.shape[0], dtype=jnp.int32) * tile

    def fold(carry, inp):
        run_dist, run_idx = carry
        block, base = inp
        scores = scores_nt(en_local, block, precision)
        cols = base + jax.lax.broadcasted_iota(jnp.int32, scores.shape, 1)
        new_dist = jnp.where(cols >= n_real, jnp.inf, 1.0 - scores)
        run_dist, run_idx = _merge_topk(
            run_dist, run_idx, new_dist, jnp.broadcast_to(cols, scores.shape),
            k,
        )
        return (run_dist, run_idx), None

    init = (jnp.full((b, k), jnp.inf, jnp.float32),
            jnp.full((b, k), -1, jnp.int32))
    (run_dist, run_idx), _ = jax.lax.scan(fold, init, (blocks, bases))
    return run_dist, run_idx


def _ring2d_body(en_local, n_hosts, n_local, k, n_real, precision):
    """Ring-over-ring on a 2-D ("hosts", "data") mesh — the schedule for
    slow links between hosts (SURVEY.md §5 distributed backend): the inner
    ring rotates candidate blocks around one host's devices (cheap,
    latency-hidden by the next matmul); only after a full inner rotation
    does ONE bulk ppermute over the hosts axis move each device's block to
    the next host. Every block crosses each host boundary exactly once over
    the whole schedule (the minimum for self-k-NN, where every host must
    see every row), and inter-host hops are n_local x fewer and n_local x
    larger than a flat 1-D ring would make them.
    Rows are sharded host-major: device (h, j) owns global rows
    [(h*n_local + j)*b, ...+b)."""
    b = en_local.shape[0]
    my_h = jax.lax.axis_index(HOST_AXIS)
    my_j = jax.lax.axis_index(DATA_AXIS)
    col_base = jax.lax.broadcasted_iota(jnp.int32, (1, b), 1)

    init_dist = jnp.full((b, k), jnp.inf, dtype=jnp.float32)
    init_idx = jnp.full((b, k), -1, dtype=jnp.int32)

    def inner(s, carry):
        t, run_dist, run_idx, block = carry
        owner_h = (my_h - t) % n_hosts
        owner_j = (my_j - s) % n_local
        scores = scores_nt(en_local, block, precision)
        base = (owner_h * n_local + owner_j).astype(jnp.int32) * b
        new_idx = jnp.broadcast_to(col_base + base, (b, b))
        new_dist = jnp.where(new_idx >= n_real, jnp.inf, 1.0 - scores)
        run_dist, run_idx = _merge_topk(run_dist, run_idx, new_dist, new_idx, k)
        block = jax.lax.ppermute(
            block, DATA_AXIS,
            perm=[(i, (i + 1) % n_local) for i in range(n_local)],
        )
        return t, run_dist, run_idx, block

    def outer(t, carry):
        run_dist, run_idx, block = carry
        _, run_dist, run_idx, block = jax.lax.fori_loop(
            0, n_local, inner, (t, run_dist, run_idx, block)
        )
        # a full inner rotation returned every block to its in-host start;
        # one bulk inter-host hop hands it to the same lane of the next host
        block = jax.lax.ppermute(
            block, HOST_AXIS,
            perm=[(i, (i + 1) % n_hosts) for i in range(n_hosts)],
        )
        return run_dist, run_idx, block

    run_dist, run_idx, _ = jax.lax.fori_loop(
        0, n_hosts, outer, (init_dist, init_idx, en_local)
    )
    return run_dist, run_idx


def _make_kernel(mesh, strategy, k, n_real, precision,
                 candidate_tile: int = 131072):
    """Build the shard_map'ed top-k kernel for a strategy; returns
    (kernel, row_spec). "ring"/"allgather" run on the 1-D data axis;
    "ring2d" needs a 2-D ("hosts", "data") mesh (make_mesh_2d) and rides
    the ring-over-ring schedule. candidate_tile (config.knn_candidate_tile)
    sizes the allgather path's selection blocks; the ring paths score each
    whole per-device block at once, which is already the widest tile."""
    if strategy == "ring2d":
        if HOST_AXIS not in mesh.axis_names:
            raise ValueError(
                "strategy 'ring2d' needs a 2-D ('hosts', 'data') mesh — "
                "build it with make_mesh_2d(n_hosts)"
            )
        n_hosts, n_local = mesh.devices.shape
        body = functools.partial(
            _ring2d_body, n_hosts=n_hosts, n_local=n_local, k=k,
            n_real=n_real, precision=precision,
        )
        row_spec = P((HOST_AXIS, DATA_AXIS), None)
    elif strategy == "allgather":
        body = functools.partial(
            _allgather_body, n_dev=mesh.devices.size, k=k, n_real=n_real,
            precision=precision, candidate_tile=candidate_tile,
        )
        row_spec = P(DATA_AXIS, None)
    else:
        body = functools.partial(
            _ring_body, n_dev=mesh.devices.size, k=k, n_real=n_real,
            precision=precision,
        )
        row_spec = P(DATA_AXIS, None)
    kernel = shard_map_norep(
        body, mesh=mesh, in_specs=row_spec, out_specs=(row_spec, row_spec),
    )
    return kernel, row_spec


def knn_exact_sharded_multihost(
    emb_local: np.ndarray,
    n_reads_global: int,
    per_process_reads: int,
    n_neighbors: int,
    strategy: str = "ring",
    precision: str = "bf16",
    transfer: str = "f32",
    candidate_tile: int = 131072,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact cosine top-k over a GLOBAL (multi-process) device mesh.

    The multi-host variant of knn_exact_sharded (SURVEY.md §2.8 / §5
    distributed backend): each process contributes only its own embedding
    rows; `jax.make_array_from_process_local_data` assembles the global
    row-sharded matrix WITHOUT any host-side gather, and the candidate
    blocks ride the ring (jax.lax.ppermute) or one all_gather across the
    device interconnect. Peak per-device memory for the ring is O(N/n_dev x d)
    — the whole-matrix copy the host-gather path pays never exists.

    emb_local: (2*local_reads, d) — this process's fwd/rev-interleaved
      embedding rows (reads [pid*per, ...) — contiguous global ranges).
    per_process_reads: the uniform per-process read quota `per` from
      host_read_range; every process's block is zero-padded to 2*per rows
      (2*per must divide evenly by the local device count — pass
      row_multiple=jax.local_device_count() to host_read_range).
    Returns (indices, distances) for THIS process's real rows, in global
    row numbering (row 2g / 2g+1 for global read g).
    """
    n_local_dev = jax.local_device_count()
    if strategy == "ring2d":
        # hosts axis == process boundary: the inner ring stays on each
        # process's devices, the outer hop is the only inter-host transfer
        mesh = make_mesh_2d(jax.process_count())
    else:
        mesh = make_mesh()  # all global devices, process-major order
    block_rows = 2 * per_process_reads
    if block_rows % n_local_dev:
        raise ValueError(
            f"per-process block of {block_rows} rows does not divide over "
            f"{n_local_dev} local devices; compute the read range with "
            f"host_read_range(..., row_multiple=local_device_count)"
        )
    d = emb_local.shape[1]
    local_block = np.zeros((block_rows, d), np.float32)
    local_block[: emb_local.shape[0]] = np.asarray(emb_local)

    n_real = 2 * n_reads_global
    k = min(n_neighbors, n_real)
    kernel, row_spec = _make_kernel(mesh, strategy, k, n_real, precision,
                                    candidate_tile)
    garr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, row_spec), local_block,
        (block_rows * jax.process_count(), d)
    )

    @jax.jit
    def run(e):
        en = normalize_rows(e)
        dist, idx = kernel(en)
        if transfer == "u16":  # quantize before the device->host copy
            dist = quantize_dist(dist)
        return dist, idx

    dist, idx = run(garr)

    def _local_rows(a):
        # this process's addressable shards, in global row order
        shards = sorted(a.addressable_shards,
                        key=lambda s: s.index[0].start or 0)
        return np.concatenate([np.asarray(s.data) for s in shards])

    n_mine = emb_local.shape[0]
    dist_np = _local_rows(dist)[:n_mine]
    if transfer == "u16":
        dist_np = dequantize_dist(dist_np)
    return _local_rows(idx)[:n_mine], dist_np


def knn_exact_sharded(
    embeddings: np.ndarray,
    n_neighbors: int,
    mesh=None,
    strategy: str = "ring",
    precision: str = "bf16",
    transfer: str = "f32",
    candidate_tile: int = 131072,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact cosine top-k with rows sharded over the mesh's data axis.

    Returns (indices (N, k) int32, distances (N, k) float32) in global row
    numbering, like knn_exact. Rows are zero-padded to a multiple of the
    mesh size; padded rows are sliced off (their garbage neighbors never
    leave this function, and zero-padding cannot enter real rows' top-k
    because zero rows have distance 1.0 to everything — only ahead of
    anti-correlated true neighbors, which is the same semantics as the
    reference's zero-hit rows).
    """
    mesh = mesh if mesh is not None else make_mesh()
    n_dev = mesh.devices.size
    n = embeddings.shape[0]
    k = min(n_neighbors, n)
    padded = jnp.asarray(embeddings)
    pad = (-n) % n_dev
    if pad:
        padded = jnp.concatenate(
            [padded, jnp.zeros((pad, padded.shape[1]), padded.dtype)]
        )

    kernel, row_spec = _make_kernel(mesh, strategy, k, n, precision,
                                    candidate_tile)

    @jax.jit
    def run(e):
        en = normalize_rows(e)
        dist, idx = kernel(en)
        if transfer == "u16":  # quantize before the device->host copy
            dist = quantize_dist(dist)
        return dist, idx

    sharded = jax.device_put(padded, NamedSharding(mesh, row_spec))
    dist, idx = run(sharded)
    dist_np = np.asarray(dist)[:n]
    if transfer == "u16":
        dist_np = dequantize_dist(dist_np)
    return transfer_idx(idx, transfer, n)[:n], dist_np
