"""Out-of-core exact k-NN: embedding matrices larger than one device.

The whole-human rung (BASELINE.json "whole-human ONT 30x / metagenome mix")
puts the (2R, d) embedding matrix past one device's memory: 2e7 reads ->
4e7 rows x 512 f32 = 82 GB vs the 60 GB JAX takes of an 80 GB H100. The
reference's answer at that scale is disk + sampling (README.md:33-49,
pynndescent over a memory-mapped matrix); the answer here is out-of-core
blocked search:

- the matrix stays HOST-resident in bf16 (half the RAM and half of every
  upload; fp32 accumulation on device keeps the scores exact to bf16
  input rounding, same as the in-core path's cast);
- query super-slabs are sized to fill the memory budget, so the number of
  candidate sweeps — and with it the total host->device traffic,
  n_slabs x N x d x 2 bytes — is minimal;
- candidate blocks stream through a DONATED running-top-k carry
  (scores/indices never re-allocate), with the next block's device_put
  issued before the current block's compute is consumed so the upload
  rides under the matmul work;
- per-slab results cross back in one small (slab, k) copy.

The search itself is exact (same tiled scan as knn/topk.py); only the
residency changes. docs/SCALING.md derives the memory model at 2e7 rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from fedrann_jax.knn.topk import (
    scores_nt,
    transfer_dist,
    transfer_idx,
)
from fedrann_jax.logging_utils import logger

# Default candidate-block rows per upload. 256k rows x 512 dims x 2 B =
# 256 MB per block: big enough to amortize a launch, small enough that
# double-buffering two blocks leaves the budget to the query slab (the
# term that actually reduces traffic).
DEFAULT_BLOCK_ROWS = 1 << 18


@functools.partial(
    jax.jit,
    donate_argnums=(0, 1),
    static_argnames=("k", "candidate_tile", "precision"),
)
def _ooc_step(carry_s, carry_i, q_tiles, block, base, n_valid, k,
              candidate_tile, precision):
    """Merge one candidate block into the running top-k.

    carry_s/carry_i: (nt, qt, k) running scores/global indices (donated —
    the carry lives in the same HBM pages for the whole sweep).
    q_tiles: (nt, qt, d) query slab. block: (c_rows, d) zero-padded
    candidate rows; base (traced) is the block's global row offset and
    n_valid its real row count, so one compiled executable serves every
    block including the ragged last one."""
    d = q_tiles.shape[-1]
    nb = block.shape[0] // candidate_tile
    blocks = block.reshape(nb, candidate_tile, d)
    bases = base + jnp.arange(nb, dtype=jnp.int32) * candidate_tile
    limit = base + n_valid

    def per_tile(args):
        tile, cs, ci = args
        tq = tile.astype(block.dtype)

        def scan_block(carry, inp):
            run_s, run_i = carry
            blk, b = inp
            scores = scores_nt(tq, blk, precision)
            cols = b + jax.lax.broadcasted_iota(jnp.int32, scores.shape, 1)
            scores = jnp.where(cols >= limit, -jnp.inf, scores)
            bs, bi = jax.lax.top_k(scores, k)
            bidx = jnp.take_along_axis(cols, bi.astype(jnp.int32), axis=1)
            merged = jnp.concatenate([run_s, bs], axis=1)
            merged_i = jnp.concatenate([run_i, bidx], axis=1)
            ts, ti = jax.lax.top_k(merged, k)
            return (ts, jnp.take_along_axis(merged_i, ti, axis=1)), None

        (s, i), _ = jax.lax.scan(scan_block, (cs, ci), (blocks, bases))
        return s, i

    return jax.lax.map(per_tile, (q_tiles, carry_s, carry_i))


def plan_ooc(n: int, d: int, k: int, hbm_budget: int,
             query_tile: int = 512, block_rows: int = DEFAULT_BLOCK_ROWS,
             itemsize: int = 2) -> tuple[int, int]:
    """(q_rows, c_rows) for a device-memory budget in bytes.

    Accounting per resident set: query slab q*d*2 (bf16) + carry q*k*8
    (f32 scores + i32 indices) + TWO candidate blocks (double buffer)
    c*d*2 + the scan's (qt, ct) f32 score temp. q_rows is maximized —
    every extra query row resident divides the candidate re-upload
    traffic — and c_rows shrinks (pow2) until two blocks fit."""
    c = block_rows
    while c > query_tile and 2 * c * d * itemsize > hbm_budget // 3:
        c //= 2
    ct = min(c, 131072)
    fixed = 2 * c * d * itemsize + query_tile * ct * 4
    per_q = d * itemsize + k * 8
    q = (hbm_budget - fixed) // per_q
    q = max(query_tile, int(q) // query_tile * query_tile)
    return q, c


def knn_exact_ooc(
    embeddings: np.ndarray,
    n_neighbors: int,
    hbm_budget: int,
    query_tile: int = 512,
    candidate_tile: int = 131072,
    precision: str = "bf16",
    transfer: str = "f32",
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact cosine top-k over a HOST-resident (N, d) matrix, streaming
    both sides through a device-memory budget (bytes). Output contract identical
    to knn_exact: (indices (N, k) int32, distances (N, k) float32),
    self at rank 0. precision='fp32' uploads fp32 (exact, 2x traffic)."""
    emb = np.asarray(embeddings)
    n, d = emb.shape
    k = min(n_neighbors, n)

    # host-side normalize + cast ONCE into the wire buffer, chunked: the
    # input is NOT mutated (it is the pipeline's result matrix) and the
    # full-size f32 normalized temp never exists (at 4e7 rows it would be
    # an 82 GB allocation)
    wire_dtype = ml_dtypes.bfloat16 if precision == "bf16" else np.float32
    host = np.empty((n, d), wire_dtype)
    for s in range(0, n, 1 << 20):
        e = np.asarray(emb[s : s + (1 << 20)], np.float32)
        norms = np.linalg.norm(e, axis=1, keepdims=True)
        host[s : s + (1 << 20)] = (
            e / np.where(norms == 0, 1.0, norms)).astype(wire_dtype)
    del emb

    itemsize = np.dtype(wire_dtype).itemsize
    q_rows, c_rows = plan_ooc(n, d, k, hbm_budget, query_tile, block_rows,
                              itemsize)
    qt = min(query_tile, max(8, n))
    ct = min(candidate_tile, c_rows)
    n_slabs = -(-n // q_rows)
    n_blocks = -(-n // c_rows)
    logger.info(
        "knn_exact_ooc: %d x %d rows host-resident (%.2f GB %s), budget "
        "%.2f GB -> %d query slabs x %d rows, %d candidate blocks x %d "
        "rows (H2D ~%.2f GB)",
        n, d, host.nbytes / 1e9, np.dtype(wire_dtype).name,
        hbm_budget / 1e9, n_slabs, q_rows, n_blocks, c_rows,
        n_slabs * host.nbytes / 1e9,
    )

    dist_dtype = jnp.float32
    idx_out = np.empty((n, k), np.int32)
    dist_out = np.empty((n, k), np.float32)

    def block_host(b):
        lo = b * c_rows
        hi = min(lo + c_rows, n)
        blk = host[lo:hi]
        if hi - lo < c_rows:  # zero-pad the ragged last block
            blk = np.concatenate(
                [blk, np.zeros((c_rows - (hi - lo), d), wire_dtype)])
        return blk

    pending = None  # (slab_start, slab_rows, carry_s, carry_i)
    for s in range(0, n, q_rows):
        rows = min(q_rows, n - s)
        pad = (-rows) % qt
        slab = host[s : s + rows]
        if pad:
            slab = np.concatenate([slab, np.zeros((pad, d), wire_dtype)])
        q_dev = jnp.asarray(slab).reshape(-1, qt, d)
        nt = q_dev.shape[0]
        carry_s = jnp.full((nt, qt, k), -jnp.inf, dist_dtype)
        carry_i = jnp.full((nt, qt, k), -1, jnp.int32)
        nxt = jax.device_put(block_host(0))  # prefetch first block
        for b in range(n_blocks):
            blk_dev = nxt
            lo = b * c_rows
            nv = min(c_rows, n - lo)
            if b + 1 < n_blocks:  # upload next while this one computes
                nxt = jax.device_put(block_host(b + 1))
            carry_s, carry_i = _ooc_step(
                carry_s, carry_i, q_dev, blk_dev, jnp.int32(lo),
                jnp.int32(nv), k, ct, precision,
            )
        if pending is not None:  # drain previous slab under this compute
            _drain(pending, idx_out, dist_out, transfer, n, qt, k)
        pending = (s, rows, carry_s, carry_i)
    _drain(pending, idx_out, dist_out, transfer, n, qt, k)
    return idx_out, dist_out


def _drain(entry, idx_out, dist_out, transfer, n, qt, k):
    s, rows, carry_s, carry_i = entry
    dist = (1.0 - carry_s).reshape(-1, k)[:rows]
    idx = carry_i.reshape(-1, k)[:rows]
    idx_out[s : s + rows] = transfer_idx(idx, transfer, n)
    dist_out[s : s + rows] = transfer_dist(dist, transfer)


# ---------------------------------------------------------------------------
# OOC x IVF composition (VERDICT r4 missing 3 / item 4b): past-HBM search
# that probes ~p/C of the candidate blocks instead of streaming all of them.


@functools.partial(jax.jit, static_argnames=("precision",))
def _assign_block(block, cent, precision):
    return scores_nt(block, cent, precision)


def _centroid_order(cent) -> np.ndarray:
    """1-D ordering of centroids by a greedy nearest-neighbor chain.
    Read embeddings live on the genome's 1-D overlap manifold, but that
    curve FOLDS arbitrarily in 512-d: a linear (PCA) projection collapses
    distant arcs onto the same coordinate (measured at the human rung:
    every query slab probed every block — 264/264 uploads). The greedy
    chain follows the curve itself: start anywhere, repeatedly hop to the
    nearest unvisited centroid (host-side, C^2 dots — trivial at C<=64k).
    Nearby clusters then land in nearby row blocks, which is what turns
    per-slab block skipping into a real traffic/FLOP reduction."""
    c = np.asarray(cent, np.float32)
    n = c.shape[0]
    # cosine similarities (centroids are unit-norm): a host numpy f32
    # product, exact to f32 rounding
    sims = c @ c.T
    np.fill_diagonal(sims, -np.inf)
    order = np.empty(n, np.int32)
    visited = np.zeros(n, bool)
    cur = 0
    for i in range(n):
        order[i] = cur
        visited[cur] = True
        row = sims[cur].copy()
        row[visited] = -np.inf
        if i + 1 < n:
            cur = int(np.argmax(row))
    return order


def knn_ivf_ooc(
    embeddings: np.ndarray,
    n_neighbors: int,
    hbm_budget: int,
    n_clusters: int | None = None,
    n_probes: int = 8,
    spill: int = 2,
    kmeans_iters: int = 3,
    query_tile: int = 512,
    candidate_tile: int = 131072,
    precision: str = "bf16",
    transfer: str = "f32",
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> tuple[np.ndarray, np.ndarray]:
    """IVF-pruned out-of-core cosine top-k: the composition of the
    sub-quadratic valve with the past-HBM streaming path (the reference's
    answer at this scale is pynndescent over a memory-mapped matrix,
    nearest_neighbors.py:39-55 + README.md:33-49).

    Structure: streaming spherical k-means over the host-resident matrix
    -> rows host-reordered by home cluster along the 1-D centroid order
    (_centroid_order) -> the exact-OOC slab/block loop (same donated
    running-top-k kernel, _ooc_step), but each query slab uploads ONLY the
    candidate blocks containing members of clusters its queries probe.
    Every scored distance is exact; a slab scores a SUPERSET of its
    queries' probed clusters (block granularity), so recall is >= the
    in-core knn_ivf at the same (C, p, spill). Self rows keep rank 0 (a
    query's own block is always needed via its home cluster).
    """
    from fedrann_jax.knn.ivf import auto_clusters

    emb = np.asarray(embeddings)
    n, d = emb.shape
    k = min(n_neighbors, n)
    c_n = n_clusters or auto_clusters(n)
    if n < 4 * c_n or (n_clusters is None and n <= 4096):
        logger.info("knn_ivf_ooc: N=%d too small for C=%d clusters; exact "
                    "ooc path", n, c_n)
        return knn_exact_ooc(emb, n_neighbors, hbm_budget,
                             query_tile=query_tile,
                             candidate_tile=candidate_tile,
                             precision=precision, transfer=transfer,
                             block_rows=block_rows)
    p = min(n_probes, c_n)
    spill = max(1, min(spill, c_n))

    wire_dtype = ml_dtypes.bfloat16 if precision == "bf16" else np.float32
    host = np.empty((n, d), wire_dtype)
    for s in range(0, n, 1 << 20):
        e = np.asarray(emb[s : s + (1 << 20)], np.float32)
        norms = np.linalg.norm(e, axis=1, keepdims=True)
        host[s : s + (1 << 20)] = (
            e / np.where(norms == 0, 1.0, norms)).astype(wire_dtype)
    del emb

    # ---- spherical k-means on a device-resident strided SAMPLE ----------
    # Training on full streaming passes would pay kmeans_iters x N x d x 2 B
    # of H2D. Centroid quality needs only a large sample: strided rows are
    # genome-position-random (read order), one upload, then every
    # iteration is device-local.
    itemsize = np.dtype(wire_dtype).itemsize
    c_rows = block_rows
    while c_rows > query_tile and 2 * c_rows * d * itemsize > hbm_budget // 2:
        c_rows //= 2
    n_blocks_km = -(-n // c_rows)
    n_sample = min(n, max(8 * c_n, 1 << 18))
    stride = max(1, n // n_sample)
    sample_rows = np.arange(0, n, stride, dtype=np.int64)[:n_sample]
    sample = jnp.asarray(np.ascontiguousarray(host[sample_rows]))
    init_rows = (np.arange(c_n, dtype=np.int64)
                 * (len(sample_rows) // c_n))
    cent = sample[jnp.asarray(init_rows)].astype(jnp.float32)

    def blk(i):
        lo = i * c_rows
        return jnp.asarray(host[lo : min(lo + c_rows, n)])

    for _ in range(kmeans_iters):
        scores = _assign_block(sample, cent, precision)
        a = jnp.argmax(scores, axis=1).astype(jnp.int32)
        sums = jax.ops.segment_sum(
            sample.astype(jnp.float32), a, num_segments=c_n)
        norm = jnp.linalg.norm(sums, axis=1, keepdims=True)
        cent = jnp.where(norm > 0, sums / jnp.where(norm == 0, 1.0, norm),
                         cent)
    del sample

    # ---- final pass: spill assignments + per-query probes ---------------
    assign = np.empty((n, spill), np.int32)
    probes = np.empty((n, p), np.int32)
    for b in range(n_blocks_km):
        lo = b * c_rows
        hi = min(lo + c_rows, n)
        scores = _assign_block(blk(b), cent, precision)
        _, top = jax.lax.top_k(scores, max(spill, p))
        top_h = np.asarray(top, np.int32)
        assign[lo:hi] = top_h[:, :spill]
        probes[lo:hi] = top_h[:, :p]

    # ---- host reorder by home cluster along the centroid manifold ------
    corder = _centroid_order(cent)              # cluster ids in 1-D order
    crank = np.empty(c_n, np.int32)
    crank[corder] = np.arange(c_n, dtype=np.int32)
    home = assign[:, 0]
    order = np.argsort(crank[home], kind="stable").astype(np.int64)
    host_r = host[order]                        # (n, d) reordered copy
    del host

    # IVF-aware granularity (budget-maximal half-dataset slabs probed
    # every block at the human rung — the exact-ooc sizing is wrong here). Probe locality lives at the
    # cluster scale (~n/C rows), so blocks shrink to ~32k rows and slabs
    # to ~8 blocks of queries: each slab's probe union then spans its own
    # cluster range plus slack instead of the whole matrix, and total
    # H2D approaches ONE logical sweep regardless of the budget.
    q_rows, _ = plan_ooc(n, d, k, hbm_budget, query_tile, c_rows, itemsize)
    c_rows = min(c_rows, 1 << 15)
    q_rows = min(q_rows, max(8 * c_rows, 1 << 18))
    qt = min(query_tile, max(8, n))
    ct = min(candidate_tile, c_rows)

    # blocks over the REORDERED rows; cluster -> blocks containing any of
    # its (spill) members: a slab then needs exactly the union over its
    # queries' probe sets
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n, dtype=np.int64)
    n_blocks = -(-n // c_rows)
    cluster_blocks = [set() for _ in range(c_n)]
    row_block = (inv // c_rows).astype(np.int32)
    for s in range(spill):
        # all rows' s-th assignment -> mark that cluster in the row's block
        np_pairs = np.stack([assign[:, s], row_block], axis=1)
        uniq = np.unique(np_pairs, axis=0)
        for cl, bk in uniq:
            cluster_blocks[cl].add(int(bk))

    idx_out = np.empty((n, k), np.int32)
    dist_out = np.empty((n, k), np.float32)
    order32 = order.astype(np.int32)

    def block_host(b):
        lo = b * c_rows
        hi = min(lo + c_rows, n)
        b_arr = host_r[lo:hi]
        if hi - lo < c_rows:
            b_arr = np.concatenate(
                [b_arr, np.zeros((c_rows - (hi - lo), d), wire_dtype)])
        return b_arr

    total_blocks_uploaded = 0
    total_votes = 0
    dropped_votes = 0
    pending = None
    probes_r = probes[order]                    # probe lists in slab order
    for s in range(0, n, q_rows):
        rows = min(q_rows, n - s)
        pad = (-rows) % qt
        slab = host_r[s : s + rows]
        if pad:
            slab = np.concatenate([slab, np.zeros((pad, d), wire_dtype)])
        q_dev = jnp.asarray(slab).reshape(-1, qt, d)
        nt = q_dev.shape[0]
        carry_s = jnp.full((nt, qt, k), -jnp.inf, jnp.float32)
        carry_i = jnp.full((nt, qt, k), -1, jnp.int32)
        # vote-thresholded block selection: without it ONE outlier query
        # per block forces the upload and coverage saturates (measured
        # 264/264 blocks at the human rung even after the chain
        # reordering). A slab always scores its OWN row range (self rows
        # + home clusters); other blocks must earn >=0.1% of the slab's
        # probe votes. Probes whose blocks are dropped lose those
        # candidates — counted and logged, and recall-vs-exact carries
        # the ground truth (bench ab rows).
        votes = np.zeros(n_blocks, np.int64)
        cls, cnts = np.unique(probes_r[s : s + rows], return_counts=True)
        for cl, cnt in zip(cls, cnts):
            for b in cluster_blocks[int(cl)]:
                votes[b] += int(cnt)
        own = set(range(s // c_rows, (s + rows - 1) // c_rows + 1))
        thresh = max(1, int(0.001 * rows))
        keep = set(np.flatnonzero(votes >= thresh).tolist()) | own
        need = sorted(keep)
        total_votes += int(votes.sum())
        dropped_votes += int(
            sum(int(votes[b]) for b in np.flatnonzero(votes > 0)
                if b not in keep))
        total_blocks_uploaded += len(need)
        nxt = jax.device_put(block_host(need[0]))
        for bi, b in enumerate(need):
            blk_dev = nxt
            lo = b * c_rows
            nv = min(c_rows, n - lo)
            if bi + 1 < len(need):
                nxt = jax.device_put(block_host(need[bi + 1]))
            carry_s, carry_i = _ooc_step(
                carry_s, carry_i, q_dev, blk_dev, jnp.int32(lo),
                jnp.int32(nv), k, ct, precision,
            )
        if pending is not None:
            _drain_reordered(pending, idx_out, dist_out, transfer, n, qt, k,
                             order32)
        pending = (s, rows, carry_s, carry_i)
    _drain_reordered(pending, idx_out, dist_out, transfer, n, qt, k, order32)
    n_slabs = -(-n // q_rows)
    logger.info(
        "knn_ivf_ooc: C=%d p=%d spill=%d -> %d/%d candidate-block uploads "
        "(%.2fx fewer than exact ooc; %.3f%% of probe votes dropped by "
        "the block threshold)",
        c_n, p, spill, total_blocks_uploaded, n_slabs * n_blocks,
        n_slabs * n_blocks / max(total_blocks_uploaded, 1),
        100.0 * dropped_votes / max(total_votes, 1),
    )
    # un-reorder the query rows back to original numbering
    idx_final = np.empty_like(idx_out)
    dist_final = np.empty_like(dist_out)
    idx_final[order] = idx_out
    dist_final[order] = dist_out
    return idx_final, dist_final


def _drain_reordered(entry, idx_out, dist_out, transfer, n, qt, k, order32):
    """_drain + candidate-id translation: _ooc_step's column ids index the
    REORDERED matrix; map them back through `order` (sentinel -1 kept)."""
    s, rows, carry_s, carry_i = entry
    dist = (1.0 - carry_s).reshape(-1, k)[:rows]
    idx = carry_i.reshape(-1, k)[:rows]
    idx_np = transfer_idx(idx, transfer, n)
    dist_np = transfer_dist(dist, transfer)
    if transfer == "u16" and n <= 65536:
        # the u16 wire clips the -1 unset marker to 0; restore it from a
        # 1-byte mask (unset slots exist only when a query's probed blocks
        # hold fewer than k rows — tiny-config territory, but exactness
        # over the wire format)
        unset = np.asarray(jax.device_get(idx < 0))
        idx_np = np.where(unset, -1, idx_np)
    idx_np = np.where(idx_np >= 0, order32[np.clip(idx_np, 0, n - 1)], -1)
    idx_out[s : s + rows] = idx_np
    dist_out[s : s + rows] = dist_np
