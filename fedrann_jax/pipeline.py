"""Pipeline orchestrator: FASTX in, overlaps.tsv out.

The device counterpart of the reference driver run_fedrann_pipeline
(reference __main__.py:302-391). Where the reference hands stages to
subprocesses via temp files (jellyfish, awk, seqkit, kmer_searcher, a
multiprocessing pool, pynndescent), every numeric stage here is a jitted
device computation over in-memory arrays; the host only streams FASTX and
writes TSV.

Stages (same 4-step shape as the reference):
  1. count   — canonical k-mer counting + multiplicity filter + sampling
  2. project — ICF x SRP precompute matrix on device
  3. embed   — per-read membership -> padded hit rows -> embeddings
  4. knn     — exact tiled cosine top-k
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from fedrann_jax.config import PipelineConfig
from fedrann_jax.io.fastx import read_fastx
from fedrann_jax.io.packing import PackedBucket, PackedReads, pack_reads
from fedrann_jax.io.tsv import write_overlaps_path
from fedrann_jax.kmers.library_device import build_library_on_device
from fedrann_jax.kmers.membership import build_library_index
from fedrann_jax.knn.topk import knn_exact
from fedrann_jax.logging_utils import (
    add_log_file,
    logger,
    remove_log_file,
    set_logging_level,
)
from fedrann_jax.metrics import MemorySampler, StageMetrics
from fedrann_jax.oracle import KmerLibrary
from fedrann_jax.project.embed import (
    embed_hits_paired_auto,
)
from fedrann_jax.project.srp import (
    build_precompute_paired,
    build_precompute_signs,
    pair_projection,
)


@dataclasses.dataclass
class PipelineResult:
    names: list[str]
    library: KmerLibrary
    embeddings: np.ndarray          # (2R, d) float32, fwd/rev interleaved
    neighbor_indices: np.ndarray    # (2R, k) int32
    neighbor_distances: np.ndarray  # (2R, k) float32
    metrics: dict
    overlaps_path: Optional[str] = None


_TIMING = bool(os.environ.get("FEDRANN_JAX_TIMING"))


def _tlog(tag: str, t0: float) -> float:
    """Sub-stage wall timer (FEDRANN_JAX_TIMING=1): prints the elapsed time
    since t0 and returns a fresh mark."""
    import time as _time

    now = _time.perf_counter()
    if _TIMING:
        print(f"[timing] {tag}: {now - t0:.3f}s", flush=True)
    return now


def _pow2_groups(n: int):
    """Binary decomposition of a chunk count into descending power-of-two
    group sizes: 176 -> [128, 32, 16]. Scanned group programs then exist
    only at pow2 trip counts (few compile variants, cache-stable across
    datasets) with ZERO padded/garbage chunks executed."""
    out = []
    bit = 1 << (max(n, 1)).bit_length()
    while n:
        bit >>= 1
        if n >= bit:
            out.append(bit)
            n -= bit
    return out


@functools.partial(
    jax.jit,
    static_argnames=("rows", "length", "mode", "k", "hit_buffer", "keep_all",
                     "block_cap", "n_chunks"),
)
def _stage_group_scan(arrs, start0, rows, length, mode, k, hit_buffer,
                      keep_all, seed32, threshold, block_cap, n_chunks):
    """ONE device program for n_chunks consecutive chunks: lax.scan over
    the chunk starts with _stage_chunk_fused's body, so a group pays one
    launch instead of one per chunk. The scan keeps the compiled body at
    the single-chunk shape. Whether the grouping still pays where a launch
    costs microseconds is unmeasured (ROADMAP design item 4). Returns
    (planes (n_chunks, rows, W), dropped (n_chunks, rows))."""
    starts = start0 + jnp.arange(n_chunks, dtype=jnp.int32) * rows

    def body(_, st):
        planes, dropped = _stage_chunk_fused.__wrapped__(
            arrs, st, rows, length, mode, k, hit_buffer, keep_all, seed32,
            threshold, block_cap,
        )
        return None, (planes, dropped)

    _, (planes, dropped) = jax.lax.scan(body, None, starts)
    return planes, dropped


@functools.partial(
    jax.jit,
    static_argnames=("rows", "length", "mode", "k", "hit_buffer", "keep_all",
                     "block_cap"),
)
def _stage_chunk_fused(arrs, start, rows, length, mode, k, hit_buffer,
                       keep_all, seed32, threshold, block_cap=None):
    """ONE device program per chunk: dynamic-slice the pre-padded bucket
    upload, decode bases, and run the candidate stage. Fusing the
    slice -> unpack -> stage chain makes one launch of three, and the
    unpacked (rows, L) bases tensor becomes a jit-internal temp instead of
    an intermediate held in device memory between launches."""
    from fedrann_jax.kmers.codec import (
        canonical_window_codes_packed,
        unpack_bases,
        unpack_bases_len,
    )
    from fedrann_jax.kmers.membership import select_candidates, stage_candidates

    sl = jax.lax.dynamic_slice_in_dim(arrs[0], start, rows, axis=0)
    if mode == "packed":
        # prefix-valid buckets skip the (rows, L) base unpack AND the
        # k-step rolling codec: window codes come straight off the uint32
        # view of the 2-bit-packed stream in O(1) passes
        # (codec.canonical_window_codes_packed)
        ll = jax.lax.dynamic_slice_in_dim(arrs[1], start, rows, axis=0)
        canon, is_fwd, valid = canonical_window_codes_packed(sl, ll, k, length)
        return select_candidates(canon, is_fwd, valid, k, hit_buffer,
                                 keep_all, seed32, threshold, block_cap)
    if mode == "bases":
        bases = sl
    elif mode == "len":
        ll = jax.lax.dynamic_slice_in_dim(arrs[1], start, rows, axis=0)
        bases = unpack_bases_len(sl, ll, length)
    else:
        vb = jax.lax.dynamic_slice_in_dim(arrs[1], start, rows, axis=0)
        bases = unpack_bases(sl, vb, length)
    return stage_candidates(bases, k, hit_buffer, keep_all, seed32, threshold,
                            block_cap=block_cap)


def _pad_rows_device(arr: jax.Array, multiple: int, fill) -> jax.Array:
    """Pad a device array's rows up to a multiple (one concat launch) so
    every chunk is a clean dynamic_slice of the same compiled shape."""
    pad = (-arr.shape[0]) % multiple
    if not pad:
        return arr
    return jnp.concatenate(
        [arr, jnp.full((pad, *arr.shape[1:]), fill, arr.dtype)]
    )


class StagedBucket:
    """One length-bucket's staged candidates, chunk-stacked: planes is a
    word-plane tuple of (n_chunks, rows, W_staged) uint32 device arrays,
    dropped (n_chunks, rows) int32, read_index (n_chunks, rows) int32 host
    array (-1 = padding row). Downstream stages scan the chunk axis inside
    single programs instead of dispatching per chunk."""

    __slots__ = ("planes", "dropped", "read_index")

    def __init__(self, planes, dropped, read_index):
        self.planes = planes
        self.dropped = dropped
        self.read_index = read_index


def _stage_chunks(packed: PackedReads, config: PipelineConfig,
                  metrics: Optional[StageMetrics] = None):
    """Upload each bucket ONCE (no host-side pad copies), then run the
    fused slice+decode+stage scan in pow2-sized chunk GROUPS (one program
    per group). Both the count and the embed stages consume the result.
    chunk_size (the reference's --chunk-size, reads per processing chunk)
    caps the rows per chunk when given. Returns [StagedBucket]. metrics (if
    given) accrues the host->device upload bytes for roofline accounting."""
    from fedrann_jax.io.packing import INVALID
    from fedrann_jax.kmers.membership import selection_cap, staging_width

    import time as _time

    # an imported reference library was NOT sampled by our hash, so the
    # hash prefilter would silently discard its true hits — stage every
    # valid window in that case
    keep_all = (config.kmer_sample_fraction >= 1.0
                or config.import_library is not None)
    seed32 = jnp.uint32(np.uint32(config.seed & 0xFFFFFFFF))
    threshold = jnp.uint32(
        min(int(config.kmer_sample_fraction * 2.0**32), 2**32 - 1)
    )

    _t = _time.perf_counter()
    out = []
    h2d_bytes = 0
    for bucket in packed.buckets:
        length = bucket.length or (
            bucket.bases.shape[1] if bucket.bases is not None else 0
        )
        rows = max(8, (config.window_batch // length) // 8 * 8)
        if config.chunk_size:
            rows = max(8, min(rows, config.chunk_size // 8 * 8 or 8))
        n_rows_total = bucket.read_index.shape[0]
        # never pad a small bucket up to the full batch size: cap by the
        # bucket's own row count rounded to a pow2 size class (keeps the
        # compiled-shape set small without inflating tiny workloads)
        rows = min(rows, max(8, 1 << (max(n_rows_total, 1) - 1).bit_length()))
        prefix_valid = False
        if bucket.bases is not None:
            mode = "bases"
            arrs = (_pad_rows_device(jnp.asarray(bucket.bases), rows, INVALID),)
        else:
            # when every row's validity is a pure prefix (no mid-read N
            # bases — the common case), per-row lengths replace the
            # valid-bits plane: a third less host->device traffic. The
            # native packer caches the answer at fill time (prefix_valid);
            # the popcount re-derivation below is only for hand-built
            # buckets and cost 0.3-4.2 s/run on the 30 MB dmel planes.
            if bucket.prefix_valid is not None:
                prefix_valid = bucket.prefix_valid
            else:
                set_bits = np.unpackbits(
                    bucket.valid_bits, axis=1
                ).sum(axis=1, dtype=np.int64)
                prefix_valid = bool(
                    (set_bits == bucket.lengths.astype(np.int64)).all()
                )
                bucket.prefix_valid = prefix_valid  # memoize: ~4 s/30 MB
            if prefix_valid:
                pb = bucket.packed_bases
                use_packed = os.environ.get(
                    "FEDRANN_JAX_PACKED_CODEC", "1") != "0"
                if use_packed and pb.shape[1] % 4 == 0 \
                        and pb.dtype == np.uint8:
                    # little-endian u32 view of the packed stream: the
                    # O(1)-pass packed codec consumes it directly (base j
                    # sits at bits 2*(j%16) of word j//16 — fastxpack.cpp
                    # fill layout)
                    mode = "packed"
                    pb = pb.view("<u4")
                else:
                    mode = "len"
                arrs = (
                    _pad_rows_device(jnp.asarray(pb), rows, 0),
                    _pad_rows_device(
                        jnp.asarray(bucket.lengths.astype(np.int32)), rows, 0
                    ),
                )
            else:
                mode = "bits"
                arrs = (
                    _pad_rows_device(jnp.asarray(bucket.packed_bases), rows, 0),
                    _pad_rows_device(jnp.asarray(bucket.valid_bits), rows, 0),
                )
        w = length - config.kmer_size + 1
        # mean + 6 sigma candidate slack (membership.staging_width);
        # overflow is detected and warned. --max-hits-per-read (None =
        # uncapped) is a REAL ceiling on the staged width: it trades
        # dropped hits for staging memory on highly repetitive reads.
        hit_buffer = w if keep_all else staging_width(
            w, config.kmer_sample_fraction
        )
        if config.max_hits_per_read is not None:
            hit_buffer = min(hit_buffer,
                             max(8, -(-config.max_hits_per_read // 8) * 8))
        block_cap = (None if keep_all
                     else selection_cap(config.kmer_sample_fraction))
        h2d_bytes += sum(int(a.nbytes) for a in arrs)
        n_chunks = -(-n_rows_total // rows)
        # host-side read-index stack (padding rows = -1)
        idx_stack = np.full((n_chunks, rows), -1, np.int32)
        flat = idx_stack.reshape(-1)
        flat[:n_rows_total] = bucket.read_index[:n_rows_total]
        group_parts = []
        ofs = 0
        for gsize in _pow2_groups(n_chunks):
            group_parts.append(_stage_group_scan(
                arrs, jnp.int32(ofs * rows), rows, length, mode,
                config.kmer_size, hit_buffer, keep_all, seed32, threshold,
                block_cap, gsize,
            ))
            ofs += gsize
        if len(group_parts) == 1:
            planes, dropped = group_parts[0]
        else:
            planes = tuple(
                jnp.concatenate([g[0][i] for g in group_parts])
                for i in range(len(group_parts[0][0]))
            )
            dropped = jnp.concatenate([g[1] for g in group_parts])
        out.append(StagedBucket(planes, dropped, idx_stack))
    if metrics is not None:
        metrics.add_work("stage", h2d_bytes=h2d_bytes)
    _t = _tlog("stage queue", _t)
    # ONE host sync for the overflow total, not one per chunk
    overflow = int(jax.device_get(
        sum(jnp.sum(b.dropped) for b in out)
    )) if out else 0
    _t = _tlog("stage sync", _t)
    if overflow:
        logger.warning(
            "candidate staging overflowed by %d occurrences; k-mer counts "
            "may undercount duplicates on highly repetitive reads "
            "(raise window_batch slack)", overflow,
        )
    return out


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_embeddings(buf, t_fwd, t_rev, e_fwd, e_rev):
    """Scatter a chunk's fwd/rev embedding rows into the device-resident
    (2R+1, d) buffer (row 2R is the garbage slot for padding reads)."""
    buf = buf.at[t_fwd].set(e_fwd)
    return buf.at[t_rev].set(e_rev)


@functools.partial(
    jax.jit, donate_argnums=(0,),
    static_argnames=("k", "bits", "steps", "packed", "lib_size", "n_chunks",
                     "d"),
)
def _embed_group_scan(buf, planes_stack, t_fwd, t_rev, start0, lib_words,
                      table, p_a, p_b, k, bits, steps, packed, lib_size,
                      n_chunks, d):
    """ONE device program embedding n_chunks consecutive chunks of a
    bucket stack: scan over the chunk axis of (n_chunks_total, rows, W)
    staged planes, fused membership -> paired embed -> scatter into the
    donated (2R+1, d) buffer per step. Same launch-amortization reasoning
    as _stage_group_scan; the compiled body stays at the single-chunk
    shape."""
    from fedrann_jax.kmers.membership import _read_hits_staged

    def body(b, i):
        pl = tuple(
            jax.lax.dynamic_index_in_dim(p, i, 0, keepdims=False)
            for p in planes_stack
        )
        tf = jax.lax.dynamic_index_in_dim(t_fwd, i, 0, keepdims=False)
        tr = jax.lax.dynamic_index_in_dim(t_rev, i, 0, keepdims=False)
        hits, _ = _read_hits_staged(pl, lib_words, table, k, bits, steps,
                                    packed)
        e_fwd, e_rev = embed_hits_paired_auto(hits, p_a, p_b, lib_size, d)
        b = b.at[tf].set(e_fwd)
        return b.at[tr].set(e_rev), None

    idxs = start0 + jnp.arange(n_chunks, dtype=jnp.int32)
    buf, _ = jax.lax.scan(body, buf, idxs)
    return buf


@functools.partial(
    jax.jit,
    static_argnames=("k", "bits", "steps", "packed", "lib_size", "d"),
)
def _embed_chunk_rows(planes, lib_words, table, p_a, p_b, k, bits, steps,
                      packed, lib_size, d):
    """Fused membership+embed returning the chunk's (rows, d) fwd/rev
    embedding blocks instead of scattering them — the out-of-core path
    places them into the HOST-resident matrix (knn/ooc.py), where a
    device-side (2R+1, d) buffer cannot exist by definition. Rows cross
    to the host in bf16: the OOC search casts to bf16 anyway (its wire
    format), and bf16 halves the device->host bytes."""
    from fedrann_jax.kmers.membership import _read_hits_staged

    hits, _ = _read_hits_staged(planes, lib_words, table, k, bits, steps,
                                packed)
    e_fwd, e_rev = embed_hits_paired_auto(hits, p_a, p_b, lib_size, d)
    return e_fwd.astype(jnp.bfloat16), e_rev.astype(jnp.bfloat16)


def compute_embeddings(
    packed: PackedReads,
    library: KmerLibrary,
    config: PipelineConfig,
    proj,
    staged_chunks,
    metrics: Optional[StageMetrics] = None,
    out: str = "device",
) -> tuple[jnp.ndarray, int]:
    """Stage 3: (2R, d) float32 embeddings in global (read0_fwd, read0_rev,
    ...) row order (reference __main__.py:277-282), DEVICE-resident — the
    matrix never crosses to the host; the k-NN consumes it in place.
    Returns (device matrix view, dropped_hits).

    out='host' (the out-of-core regime, docs/SCALING.md): each chunk's
    embedding rows cross to the host as they are produced and the matrix
    is a host numpy buffer — the (2R+1, d) device buffer never exists, so
    the stage scales to matrices past HBM. Returns (np.ndarray, dropped)."""
    from fedrann_jax.kmers.membership import read_hits_staged

    import time as _time

    _t = _time.perf_counter()
    n_reads = packed.n_reads
    p_a, p_b = proj  # dense paired table OR (packed signs, mags) — embed.py
    d = (config.embedding_dimension if p_a.dtype == jnp.uint32
         else p_a.shape[1] // 2)
    host_out = out == "host"
    if host_out:
        import ml_dtypes

        # bf16 host matrix: the OOC search's own wire precision, at half
        # the D2H bytes and host RAM of f32
        buf_h = np.zeros((2 * n_reads, d), ml_dtypes.bfloat16)
        buf = None
    else:
        buf = jnp.zeros((2 * n_reads + 1, d), dtype=jnp.float32)
    # device-built libraries index without a host round trip
    from fedrann_jax.kmers.library_device import DeviceLibrary
    from fedrann_jax.kmers.membership import build_library_index_device

    if isinstance(library, DeviceLibrary):
        lib_index = build_library_index_device(library)
    else:
        lib_index = build_library_index(library.codes, config.kmer_size)
    dropped_parts = []
    # chunk-split reads (longer than the largest bucket) have one hit row
    # PER SEGMENT; those rows are diverted from the normal scatter and
    # merged as an exact per-read hit UNION below (presence-set semantics
    # over the whole read, matching the reference's unbounded streaming —
    # fastx_io.py:158-183 — and our oracle bit-for-bit: with k-1 segment
    # overlap every window lands in exactly one segment)
    split_ids = (set(int(i) for i in packed.split_read_ids)
                 if packed.split_read_ids is not None else set())
    split_id_arr = (np.fromiter(split_ids, np.int64, len(split_ids))
                    if split_ids else None)
    split_rows: list[tuple[np.ndarray, np.ndarray]] = []
    _t = _tlog("embed prep (lib index upload)", _t)
    # roofline accounting: the embed stage is bound by projection-table row
    # gathers — one 2d-wide paired row per staged slot (fwd + mirrored rev
    # halves) plus the (2R, d) f32 output writes
    staged_slots = sum(
        int(b.planes[0].size) for b in staged_chunks if b is not None
    )
    if metrics is not None:
        metrics.add_work(
            "embed",
            hbm_bytes=(1.0 * staged_slots
                       * (p_a.shape[1] * p_a.dtype.itemsize + 4)
                       + 2.0 * n_reads * d * 4),
        )

    garbage = 2 * n_reads
    for bi in range(len(staged_chunks)):
        bucket = staged_chunks[bi]
        planes, dropped_b, idx_stack = (bucket.planes, bucket.dropped,
                                        bucket.read_index)
        # embed is the LAST consumer of the staged buffers: free each
        # bucket as it is consumed
        staged_chunks[bi] = None
        n_chunks = idx_stack.shape[0]
        keep = idx_stack >= 0
        is_split = (np.isin(idx_stack, split_id_arr)
                    if split_id_arr is not None
                    else np.zeros_like(keep))
        dropped_parts.append(jnp.sum(dropped_b))
        if library.size == 0:
            continue  # zero-hit rows stay exact zero vectors
        keep_scan = keep & ~is_split
        t_fwd = np.where(keep_scan, 2 * idx_stack.astype(np.int64),
                         garbage).astype(np.int32)
        t_rev = np.where(keep_scan, 2 * idx_stack.astype(np.int64) + 1,
                         garbage).astype(np.int32)
        if host_out:
            # out-of-core regime: each chunk's rows cross to the host as
            # produced (the device buffer must never exist) — per-chunk
            # dispatch is inherent to the host round trip here
            for ci in range(n_chunks):
                pl = tuple(p[ci] for p in planes)
                e_fwd, e_rev = _embed_chunk_rows(
                    pl, lib_index.words, lib_index.table, p_a, p_b,
                    config.kmer_size, lib_index.bits, lib_index.steps,
                    lib_index.packed, library.size, d,
                )
                rows = np.flatnonzero(keep_scan[ci])
                buf_h[2 * idx_stack[ci][rows]] = np.asarray(e_fwd)[rows]
                buf_h[2 * idx_stack[ci][rows] + 1] = np.asarray(e_rev)[rows]
        else:
            tf_dev = jnp.asarray(t_fwd)
            tr_dev = jnp.asarray(t_rev)
            ofs = 0
            for gsize in _pow2_groups(n_chunks):
                buf = _embed_group_scan(
                    buf, planes, tf_dev, tr_dev, jnp.int32(ofs),
                    lib_index.words, lib_index.table, p_a, p_b,
                    config.kmer_size, lib_index.bits, lib_index.steps,
                    lib_index.packed, library.size, gsize, d,
                )
                ofs += gsize
        if is_split.any():
            # slow path per affected chunk: the segment hit rows must
            # reach the host for the exact per-read union
            for ci in np.flatnonzero(is_split.any(axis=1)):
                pl = tuple(p[int(ci)] for p in planes)
                hits, _, _ = read_hits_staged(
                    (pl, dropped_b[int(ci)]), lib_index, config.kmer_size,
                )
                rows = np.flatnonzero(keep[ci] & is_split[ci])
                split_rows.append(
                    (idx_stack[ci][rows], np.asarray(hits[rows])))

    if split_rows:
        sentinel = 2 * library.size
        by_read: dict[int, list[np.ndarray]] = {}
        for ids, rows in split_rows:
            for rid, row in zip(ids, rows):
                by_read.setdefault(int(rid), []).append(row)
        unions = []
        for rid, rows in sorted(by_read.items()):
            u = np.unique(np.concatenate(rows))
            unions.append((rid, u[u < sentinel]))
        width = max(8, -(-max(len(u) for _, u in unions) // 8) * 8)
        m = len(unions)
        hit_mat = np.full((m, width), sentinel, np.int32)
        for r, (_, u) in enumerate(unions):
            hit_mat[r, : len(u)] = u
        e_fwd, e_rev = embed_hits_paired_auto(
            jnp.asarray(hit_mat), p_a, p_b, library.size, d)
        # int32 scatter indices (device ints are 32-bit words)
        rids = np.asarray([rid for rid, _ in unions], np.int32)
        if host_out:
            buf_h[2 * rids] = np.asarray(e_fwd)
            buf_h[2 * rids + 1] = np.asarray(e_rev)
        else:
            buf = _scatter_embeddings(
                buf, jnp.asarray(2 * rids), jnp.asarray(2 * rids + 1),
                e_fwd, e_rev,
            )
        logger.info("merged %d chunk-split reads (exact hit union)", m)
    _t = _tlog("embed queue", _t)
    total_dropped = int(sum(int(x) for x in jax.device_get(dropped_parts))) \
        if dropped_parts else 0
    _t = _tlog("embed sync", _t)
    if total_dropped:
        hint = ("raise --max-hits-per-read"
                if config.max_hits_per_read is not None
                else "the reads are repetitive beyond the mean+6-sigma "
                     "staging slack; lower --kmer-sample-fraction or raise "
                     "window_batch")
        logger.warning(
            "staging buffer overflowed: %d hit occurrences dropped before "
            "membership (%s)", total_dropped, hint,
        )
    if host_out:
        return buf_h, total_dropped
    return buf[: 2 * n_reads], total_dropped


def run_pipeline(config: PipelineConfig) -> PipelineResult:
    set_logging_level(config.log_level)
    out_dir = config.output_dir
    log_handler = None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        log_handler = add_log_file(os.path.join(out_dir, "fedrann.log"))
    metrics = StageMetrics()
    sampler = (
        MemorySampler(os.path.join(out_dir or ".", "mprof.dat"))
        if config.mprof
        else None
    )
    ckpt_dir = os.path.join(out_dir, "checkpoints") if (config.checkpoint and out_dir) else None
    if ckpt_dir:
        os.makedirs(ckpt_dir, exist_ok=True)

    profiler_ctx = None
    if config.profile and out_dir:
        profiler_ctx = jax.profiler.trace(os.path.join(out_dir, "trace"))
        profiler_ctx.__enter__()
    if sampler:
        sampler.__enter__()
    try:
        with metrics.stage("load"):
            from fedrann_jax.io import native as native_io
            from fedrann_jax.io.cache import (
                cache_meta,
                load_packed_cache,
                save_packed_cache,
            )

            cache_path = (
                os.path.join(out_dir, "fxcache.npz")
                if (config.pack_cache and out_dir) else None
            )
            # reads longer than the largest bucket are chunk-split into
            # k-1-overlapped segments (merged back at embed time)
            split_overlap = config.kmer_size - 1
            packed = None
            meta = None
            parser = "cache"
            if cache_path:
                meta = cache_meta(config.input_path, config.length_buckets,
                                  split_overlap)
                packed = load_packed_cache(cache_path, meta)
            if packed is None:
                if native_io.native_available():
                    parser = "native"
                    packed = native_io.pack_reads_native(
                        config.input_path, config.length_buckets,
                        bit_packed=True, threads=max(1, config.threads),
                        split_overlap=split_overlap,
                    )
                else:
                    parser = "python"
                    packed = pack_reads(
                        read_fastx(config.input_path), config.length_buckets,
                        split_overlap=split_overlap,
                    )
                if cache_path:
                    save_packed_cache(cache_path, packed, meta)
            metrics.set_info("load", parser=parser)
            logger.info("loaded %d reads into %d buckets (parser: %s)",
                        packed.n_reads, len(packed.buckets), parser)
            if packed.n_reads == 0:
                raise ValueError(
                    f"no reads found in {config.input_path}"
                )

        # staging is the dominant device work; make it lazy + memoized so a
        # fully-checkpointed resume (library + embeddings on disk) skips it
        _staged_cache: list = []

        def get_staged():
            if not _staged_cache:
                with metrics.stage("stage"):
                    _staged_cache.append(_stage_chunks(packed, config,
                                                       metrics))
            return _staged_cache[0]

        with metrics.stage("count"):
            library = _load_or_build_library(
                packed, config, ckpt_dir, get_staged
            )
            logger.info("library: %d canonical k-mers (%d features)",
                        library.size, library.n_features)
            if library.size == 0:
                raise ValueError(
                    "k-mer library is empty: no k-mer passed the "
                    "multiplicity/sampling filters (lower "
                    "--kmer-min-multiplicity or raise "
                    "--kmer-sample-fraction)"
                )

        with metrics.stage("project"):
            if config.import_projection:
                from fedrann_jax.compat import (
                    load_reference_library_mapping,
                    load_reference_precompute,
                )

                # a reference projection is indexed in the reference's
                # file-order feature space; with an imported library, the
                # mapping permutes its rows into OUR sorted-canonical
                # extended index space so membership hits select exactly
                # the reference's projection rows (compat.py docstring)
                perm = None
                if config.import_library:
                    _, perm = load_reference_library_mapping(
                        config.import_library, config.kmer_size
                    )
                p_flat = load_reference_precompute(
                    config.import_projection, perm
                )
                if p_flat.shape[0] != library.n_features + 1:
                    raise ValueError(
                        f"imported projection has {p_flat.shape[0] - 1} "
                        f"feature rows; library needs {library.n_features}"
                    )
                # host-side re-layout into the embed stage's paired format
                # (one 2d-wide row per canonical feature, srp.py)
                proj = (jnp.asarray(pair_projection(p_flat, xp=np)),
                        jnp.zeros((1,), jnp.float32))
                logger.info("imported reference projection %s %s (paired)",
                            config.import_projection, p_flat.shape)
            else:
                # DeviceLibrary counts are already on device; .counts
                # would D2H them only to re-upload
                counts_dev = getattr(library, "counts_dev", None)
                counts_arr = (counts_dev if counts_dev is not None
                              else jnp.asarray(library.counts))
                if config.projection_dtype == "signs":
                    # 2-bit-packed ternary signs + per-row f32 magnitude:
                    # 8x smaller than the bf16 dense table and
                    # reconstructs the f32 entries EXACTLY
                    # (srp.build_precompute_signs)
                    proj = build_precompute_signs(
                        counts_arr, config.embedding_dimension,
                        config.projection_seed, config.projection_density,
                    )
                else:
                    p_dtype = (jnp.float32
                               if config.projection_dtype == "f32"
                               else jnp.bfloat16)
                    proj = (build_precompute_paired(
                        counts_arr, config.embedding_dimension,
                        config.projection_seed, config.projection_density,
                        dtype=p_dtype,
                    ), jnp.zeros((1,), jnp.float32))

        # out-of-core decision BEFORE embed: past the budget the (2R+1, d)
        # device buffer must never exist, so the embed stage itself routes
        # its chunk rows to a host-resident matrix (docs/SCALING.md)
        ooc = (config.knn_hbm_budget is not None
               and 2 * packed.n_reads * config.embedding_dimension * 6
               > config.knn_hbm_budget)
        if ooc:
            logger.info(
                "embedding matrix %.2f GB + search copy exceeds the %.2f GB "
                "device-memory budget: out-of-core path (host-resident matrix, "
                "streamed k-NN)",
                2 * packed.n_reads * config.embedding_dimension * 4 / 1e9,
                config.knn_hbm_budget / 1e9,
            )

        with metrics.stage("embed"):
            emb = _load_embeddings_checkpoint(config, ckpt_dir, packed, library)
            if emb is not None and ooc:
                emb = np.asarray(emb)
            if emb is None:
                emb, _ = compute_embeddings(
                    packed, library, config, proj, get_staged(), metrics,
                    out="host" if ooc else "device",
                )
                if ckpt_dir:
                    from fedrann_jax.io.blockio import np_save_chunked

                    np_save_chunked(os.path.join(ckpt_dir, "embeddings.npy"),
                                    np.asarray(emb))
                    with open(os.path.join(ckpt_dir, "embeddings_meta.json"),
                              "w") as f:
                        json.dump(_embed_fingerprint(config, packed, library), f)

        # embed was the last consumer of the projection table: release it
        # before the k-NN allocates its normalized copy
        del proj

        with metrics.stage("knn"):
            n_dev = len(jax.devices())
            use_mesh = (config.knn_sharded == "always"
                        or (config.knn_sharded == "auto" and n_dev > 1))
            if ooc and config.knn_method == "ivf":
                # sub-quadratic x past-HBM composition (VERDICT r4 item
                # 4b): rows host-reordered by home cluster along the 1-D
                # centroid order; each query slab uploads only the
                # candidate blocks its probes touch (knn/ooc.py)
                from fedrann_jax.knn.ooc import knn_ivf_ooc

                if use_mesh:
                    logger.warning(
                        "out-of-core k-NN streams through one device; "
                        "mesh sharding is overridden past the HBM budget"
                    )
                idx, dist = knn_ivf_ooc(
                    emb, config.n_neighbors,
                    hbm_budget=config.knn_hbm_budget,
                    n_clusters=config.knn_ivf_clusters,
                    n_probes=config.knn_ivf_probes,
                    spill=config.knn_ivf_spill,
                    query_tile=config.knn_query_tile,
                    candidate_tile=config.knn_candidate_tile,
                    precision=config.knn_precision,
                    transfer=config.knn_transfer,
                )
            elif ooc:
                from fedrann_jax.knn.ooc import knn_exact_ooc

                if use_mesh:
                    logger.warning(
                        "out-of-core k-NN streams through one device; "
                        "mesh sharding is overridden past the HBM budget"
                    )
                idx, dist = knn_exact_ooc(
                    emb, config.n_neighbors,
                    hbm_budget=config.knn_hbm_budget,
                    query_tile=config.knn_query_tile,
                    candidate_tile=config.knn_candidate_tile,
                    precision=config.knn_precision,
                    transfer=config.knn_transfer,
                )
            elif config.knn_method == "ivf" and not use_mesh:
                from fedrann_jax.knn.ivf import knn_ivf

                idx, dist = knn_ivf(
                    emb, config.n_neighbors,
                    n_clusters=config.knn_ivf_clusters,
                    n_probes=config.knn_ivf_probes,
                    spill=config.knn_ivf_spill,
                    precision=config.knn_precision,
                    transfer=config.knn_transfer,
                )
            elif use_mesh and config.knn_method == "ivf":
                from fedrann_jax.knn.ivf import knn_ivf_sharded
                from fedrann_jax.parallel.mesh import make_mesh

                mesh = make_mesh(config.mesh_shape)
                logger.info("IVF k-NN sharded over %d devices",
                            mesh.devices.size)
                idx, dist = knn_ivf_sharded(
                    emb, config.n_neighbors, mesh=mesh,
                    n_clusters=config.knn_ivf_clusters,
                    n_probes=config.knn_ivf_probes,
                    spill=config.knn_ivf_spill,
                    precision=config.knn_precision,
                    transfer=config.knn_transfer,
                )
            elif use_mesh:
                from fedrann_jax.knn.ring import knn_exact_sharded
                from fedrann_jax.parallel.mesh import make_mesh, make_mesh_2d

                if config.knn_shard_strategy == "ring2d":
                    # 2-D ("hosts", "data") mesh: mesh_shape=(H, D) uses
                    # the first H*D devices; any other mesh_shape cannot
                    # express a hosts axis, so say so instead of silently
                    # dropping it
                    if config.mesh_shape and len(config.mesh_shape) == 2:
                        n_hosts, n_local = config.mesh_shape
                        mesh = make_mesh_2d(
                            n_hosts,
                            devices=jax.devices()[: n_hosts * n_local],
                        )
                    else:
                        if config.mesh_shape:
                            logger.warning(
                                "mesh_shape %s is not (hosts, data); "
                                "ring2d uses a (1, n_devices) mesh instead",
                                config.mesh_shape,
                            )
                        mesh = make_mesh_2d(1)
                else:
                    mesh = make_mesh(config.mesh_shape)
                logger.info("k-NN sharded over %d devices (%s)",
                            mesh.devices.size, config.knn_shard_strategy)
                idx, dist = knn_exact_sharded(
                    emb, config.n_neighbors, mesh=mesh,
                    strategy=config.knn_shard_strategy,
                    precision=config.knn_precision,
                    transfer=config.knn_transfer,
                    candidate_tile=config.knn_candidate_tile,
                )
            else:
                idx, dist = knn_exact(
                    emb, config.n_neighbors,
                    query_tile=config.knn_query_tile,
                    candidate_tile=config.knn_candidate_tile,
                    precision=config.knn_precision,
                    transfer=config.knn_transfer,
                )
            # distance-matmul FLOPs: exact all-vs-all is 2*N^2*d; the IVF
            # path probes ~p/C of the candidates (knn/ivf.py cost model).
            # The result matrices are the device->host payload (the u16
            # wire halves both when active — knn/topk.py)
            n_rows_knn = int(emb.shape[0])
            flops = 2.0 * n_rows_knn * n_rows_knn * emb.shape[1]
            if config.knn_method == "ivf":
                from fedrann_jax.knn.ivf import auto_clusters

                c_eff = config.knn_ivf_clusters or auto_clusters(n_rows_knn)
                flops *= min(1.0, config.knn_ivf_probes / max(c_eff, 1))
            elem = 2 if config.knn_transfer == "u16" else 4
            idx_elem = (2 if (config.knn_transfer == "u16"
                              and n_rows_knn <= 65536) else 4)
            metrics.add_work(
                "knn",
                flops=flops,
                d2h_bytes=float(idx.shape[0] * idx.shape[1]
                                * (elem + idx_elem)),
            )

        with metrics.stage("output"):
            overlaps_path = None
            if out_dir:
                overlaps_path = os.path.join(out_dir, "overlaps.tsv")
                n_rows = write_overlaps_path(
                    overlaps_path, packed.names, idx, dist
                )
                logger.info("wrote %d overlap rows to %s", n_rows, overlaps_path)
                if config.save_feature_matrix:
                    # the reference documents feature_matrix.npz but never
                    # writes it (README.md:66, SURVEY.md §2.4); we do.
                    from fedrann_jax.io.blockio import np_savez_chunked

                    np_savez_chunked(
                        os.path.join(out_dir, "feature_matrix.npz"),
                        compressed=True,
                        embeddings=np.asarray(emb),
                        names=np.array(packed.names),
                    )
    finally:
        if sampler:
            sampler.__exit__(None, None, None)
        if profiler_ctx is not None:
            profiler_ctx.__exit__(None, None, None)
        if log_handler is not None:
            remove_log_file(log_handler)

    if out_dir:
        with open(os.path.join(out_dir, "metrics.json"), "w") as f:
            json.dump(metrics.summary(), f, indent=2)

    return PipelineResult(
        names=packed.names,
        library=library,
        embeddings=emb,
        neighbor_indices=idx,
        neighbor_distances=dist,
        metrics=metrics.summary(),
        overlaps_path=overlaps_path if out_dir else None,
    )


def _input_identity(config: PipelineConfig) -> dict:
    """Identity of the input dataset (path + size + mtime). Checkpoint
    resume must not survive a changed or different input file (ADVICE r1:
    the k/seed-only fingerprints silently reused a stale library)."""
    try:
        st = os.stat(config.input_path)
        return {
            "path": os.path.abspath(config.input_path),
            "size": st.st_size,
            "mtime_ns": st.st_mtime_ns,
        }
    except OSError:
        return {"path": os.path.abspath(config.input_path)}


def _embed_fingerprint(config: PipelineConfig, packed: PackedReads,
                       library: KmerLibrary) -> dict:
    """Everything the embedding matrix depends on; guards checkpoint resume."""
    return {
        "input": _input_identity(config),
        "k": config.kmer_size,
        "seed": config.seed,
        "fraction": config.kmer_sample_fraction,
        "min_multiplicity": config.kmer_min_multiplicity,
        "dim": config.embedding_dimension,
        "projection_seed": config.projection_seed,
        "projection_density": config.projection_density,
        "projection_dtype": config.projection_dtype,
        "import_library": config.import_library,
        "import_projection": config.import_projection,
        "max_hits": config.max_hits_per_read,
        "n_reads": packed.n_reads,
        "library_size": library.size,
    }


def _load_embeddings_checkpoint(config, ckpt_dir, packed, library):
    """Resume the embedding matrix when a prior run saved it with an
    identical fingerprint (SURVEY.md §5 checkpoint/resume)."""
    if not ckpt_dir:
        return None
    npy = os.path.join(ckpt_dir, "embeddings.npy")
    meta_path = os.path.join(ckpt_dir, "embeddings_meta.json")
    if not (os.path.exists(npy) and os.path.exists(meta_path)):
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    if meta != _embed_fingerprint(config, packed, library):
        return None
    logger.info("resuming embeddings from %s", npy)
    return jnp.asarray(np.load(npy))


def _try_load_library_ckpt(config: PipelineConfig,
                           ckpt_dir: Optional[str]) -> Optional[KmerLibrary]:
    """Load the library checkpoint if present with a matching fingerprint.
    The fingerprint is launch-mode-independent (the multi-host count merge
    is bit-identical to a single-host build), so single- and multi-host
    runs can resume each other's library."""
    if not ckpt_dir:
        return None
    path = os.path.join(ckpt_dir, "library.npz")
    if not os.path.exists(path):
        return None
    data = np.load(path)
    if (int(data["k"]) == config.kmer_size
            and int(data["seed"]) == config.seed
            and float(data["fraction"]) == config.kmer_sample_fraction
            and int(data.get("min_multiplicity", -1))
            == config.kmer_min_multiplicity
            and str(data.get("input_id", ""))
            == json.dumps(_input_identity(config), sort_keys=True)):
        logger.info("resuming library from %s", path)
        return KmerLibrary(codes=data["codes"], counts=data["counts"])
    return None


def _save_library_ckpt(config: PipelineConfig, ckpt_dir: str,
                       library: KmerLibrary) -> None:
    from fedrann_jax.io.blockio import np_savez_chunked

    np_savez_chunked(
        os.path.join(ckpt_dir, "library.npz"),
        codes=library.codes, counts=library.counts,
        k=config.kmer_size, seed=config.seed,
        fraction=config.kmer_sample_fraction,
        min_multiplicity=config.kmer_min_multiplicity,
        input_id=json.dumps(_input_identity(config), sort_keys=True),
    )


def _load_or_build_library(
    packed: PackedReads, config: PipelineConfig, ckpt_dir: Optional[str],
    get_staged=None,
) -> KmerLibrary:
    """Stage-boundary checkpoint: resume the library if a prior run saved it
    (SURVEY.md §5 checkpoint/resume — absent in the reference)."""
    if config.import_library:
        from fedrann_jax.compat import load_reference_library

        library = load_reference_library(config.import_library, config.kmer_size)
        logger.info("imported reference library %s (%d k-mers)",
                    config.import_library, library.size)
        return library
    library = _try_load_library_ckpt(config, ckpt_dir)
    if library is not None:
        return library

    # staged sampled candidates stay on device; the sampled library is the
    # only k-mer artifact that ever reaches the host
    if get_staged is None:
        staged_chunks = _stage_chunks(packed, config)
    else:
        staged_chunks = get_staged()
    from fedrann_jax.kmers.membership import staged_codes

    # ONE launch per bucket: staged_codes is shape-agnostic over the
    # chunk-stacked (n_chunks, rows, W) planes
    canon_chunks = [
        staged_codes(b.planes, config.kmer_size) for b in staged_chunks
    ]
    library = build_library_on_device(
        canon_chunks, config.kmer_size, config.kmer_min_multiplicity,
        config.kmer_sample_fraction, config.seed,
        presampled=config.kmer_sample_fraction < 1.0,
    )
    if ckpt_dir:
        _save_library_ckpt(config, ckpt_dir, library)
    return library
