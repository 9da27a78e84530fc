"""Every device stage must match the numpy oracle exactly (or within fp
tolerance for float stages)."""

import jax.numpy as jnp
import numpy as np
import pytest

from fedrann_jax import oracle
from fedrann_jax.io.packing import encode_bases, pack_reads
from fedrann_jax.io.fastx import FastxRecord
from fedrann_jax.kmers.codec import (
    canonical_window_codes,
    splitmix64,
    window_codes,
    words_to_u64,
)
from helpers_count import count_canonical_kmers
from fedrann_jax.kmers.membership import (
    library_device_words,
    mirror_hits,
    read_hits,
)
from helpers_count import build_library_device
from fedrann_jax.knn.topk import knn_exact
from fedrann_jax.project.embed import embed_hits
from fedrann_jax.project.srp import build_precompute, icf_weights_device
from fedrann_jax.sim import simulate_reads


def _random_bases(rng, r, l, n_frac=0.01):
    b = rng.integers(0, 4, size=(r, l)).astype(np.uint8)
    b[rng.random((r, l)) < n_frac] = 4
    return b


def test_splitmix64_matches_oracle():
    x = np.random.default_rng(0).integers(0, 2**63, size=1000, dtype=np.uint64)
    dev = np.asarray(splitmix64(jnp.asarray(x)))
    assert np.array_equal(dev, oracle.splitmix64(x))


@pytest.mark.parametrize("k", [3, 15, 16, 17, 21, 31])
def test_window_codes_match_oracle(k):
    rng = np.random.default_rng(k)
    bases = _random_bases(rng, 6, 100)
    code_w, rc_w, valid = window_codes(jnp.asarray(bases), k)
    codes = words_to_u64(tuple(np.asarray(w) for w in code_w))
    rc = words_to_u64(tuple(np.asarray(w) for w in rc_w))
    valid = np.asarray(valid)
    for r in range(6):
        expect = oracle.kmer_code(bases[r], k)
        exp_valid = expect != np.uint64(0xFFFFFFFFFFFFFFFF)
        assert np.array_equal(valid[r], exp_valid)
        assert np.array_equal(codes[r][exp_valid], expect[exp_valid])
        exp_rc = oracle.revcomp_code(expect[exp_valid], k)
        assert np.array_equal(rc[r][exp_valid], exp_rc)


@pytest.mark.parametrize("k", [15, 16, 21])
def test_canonical_window_codes_match_oracle(k):
    rng = np.random.default_rng(7)
    bases = _random_bases(rng, 4, 200)
    canon_w, is_fwd, valid = canonical_window_codes(jnp.asarray(bases), k)
    canon = words_to_u64(tuple(np.asarray(w) for w in canon_w))
    valid = np.asarray(valid)
    for r in range(4):
        codes = oracle.kmer_code(bases[r], k)
        v = codes != np.uint64(0xFFFFFFFFFFFFFFFF)
        expect = oracle.canonical_code(codes[v], k)
        assert np.array_equal(canon[r][valid[r]], expect)


@pytest.mark.parametrize("k", [11, 21])
def test_count_matches_oracle(k):
    sim = simulate_reads(genome_length=8000, coverage=6, mean_read_length=900, seed=5)
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(2048,),
    )
    codes, counts = count_canonical_kmers([b.bases for b in packed.buckets], k)
    # oracle count
    lib = oracle.build_library(sim.sequences, k, min_multiplicity=1,
                               sample_fraction=1.0, seed=0)
    assert np.array_equal(codes, lib.codes)
    assert np.array_equal(counts, lib.counts)


def test_count_chunk_merge():
    """Counting in several batches must equal counting in one."""
    rng = np.random.default_rng(3)
    bases = _random_bases(rng, 32, 500, n_frac=0.02)
    one = count_canonical_kmers([bases], 9)
    many = count_canonical_kmers([bases[i : i + 8] for i in range(0, 32, 8)], 9)
    assert np.array_equal(one[0], many[0])
    assert np.array_equal(one[1], many[1])


def _mk_library(sim, k, frac=0.5, seed=9, min_mult=2):
    return oracle.build_library(sim.sequences, k, min_mult, frac, seed)


def test_device_library_matches_oracle():
    sim = simulate_reads(genome_length=6000, coverage=6, mean_read_length=700, seed=2)
    k = 13
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(2048,),
    )
    codes, counts = count_canonical_kmers([b.bases for b in packed.buckets], k)
    lib_dev = build_library_device(codes, counts, 2, 0.3, seed=17)
    lib_orc = oracle.build_library(sim.sequences, k, 2, 0.3, seed=17)
    assert np.array_equal(lib_dev.codes, lib_orc.codes)
    assert np.array_equal(lib_dev.counts, lib_orc.counts)


@pytest.mark.parametrize("k", [13, 21])
def test_read_hits_match_oracle(k):
    sim = simulate_reads(genome_length=6000, coverage=5, mean_read_length=800, seed=4)
    lib = _mk_library(sim, k)
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(2048,),
    )
    bucket = packed.buckets[0]
    hits, n_hits, dropped = read_hits(
        jnp.asarray(bucket.bases), library_device_words(lib.codes, k),
        k, max_hits=2048,
    )
    hits, n_hits = np.asarray(hits), np.asarray(n_hits)
    assert np.asarray(dropped).sum() == 0
    sentinel = 2 * lib.size
    for row in range(bucket.bases.shape[0]):
        ri = bucket.read_index[row]
        got = hits[row][hits[row] != sentinel]
        if ri < 0:
            assert len(got) == 0
            continue
        expect = oracle.read_feature_indices(sim.sequences[ri], k, lib)
        # hits are sentinel-padded and (code, strand)-ordered, not
        # feature-ordered: compare as sets
        assert np.array_equal(np.sort(got), expect), f"read {ri}"
        assert n_hits[row] == len(expect)


def test_read_hits_buffer_drops_and_reports():
    """An undersized staging buffer must REPORT drops (max_hits caps the
    staging-buffer width; occurrences beyond it count as dropped)."""
    sim = simulate_reads(genome_length=4000, coverage=3, mean_read_length=600, seed=6)
    k = 9
    lib = _mk_library(sim, k, frac=1.0, min_mult=1)
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(1024,),
    )
    bucket = packed.buckets[0]
    cap = 16
    hits, n_hits, dropped = read_hits(
        jnp.asarray(bucket.bases), library_device_words(lib.codes, k),
        k, max_hits=cap, hit_buffer=cap,
    )
    hits, n_hits, dropped = map(np.asarray, (hits, n_hits, dropped))
    real = bucket.read_index >= 0
    assert dropped[real].sum() > 0  # every window staged: 16 slots overflow
    assert n_hits.max() <= cap
    # kept entries are the smallest (code, strand) candidates — a subset of
    # the oracle's feature set
    row = int(np.where(real)[0][0])
    expect = oracle.read_feature_indices(sim.sequences[bucket.read_index[row]], k, lib)
    sentinel = 2 * lib.size
    got = hits[row][hits[row] != sentinel]
    assert set(got) <= set(expect)


def test_mirror_hits_matches_oracle():
    lib_size = 10
    sentinel = 2 * lib_size
    hits = np.array([[0, 3, 12, 17, sentinel, sentinel]], dtype=np.int32)
    mirrored = np.asarray(mirror_hits(jnp.asarray(hits), lib_size))
    real = mirrored[0][mirrored[0] != sentinel]
    expect = oracle.mirror_indices(np.array([0, 3, 12, 17]), lib_size)
    assert np.array_equal(np.sort(real), np.sort(expect))


def test_icf_and_precompute_match_oracle():
    counts = np.array([2, 7, 13, 40], dtype=np.int64)
    lib = oracle.KmerLibrary(codes=np.arange(4, dtype=np.uint64), counts=counts)
    w_dev = np.asarray(icf_weights_device(jnp.asarray(counts)))
    assert np.allclose(w_dev, oracle.icf_weights(lib), rtol=1e-6)

    d, seed = 64, 2094
    p_dev = np.asarray(build_precompute(jnp.asarray(counts), d, seed, chunk=3))
    srp = oracle.srp_matrix(8, d, seed)
    expect = srp * oracle.icf_weights(lib)[:, None]
    assert p_dev.shape == (9, d)
    assert np.allclose(p_dev[:8], expect, rtol=1e-5, atol=1e-7)
    assert np.all(p_dev[8] == 0)


def test_embed_hits_matches_oracle():
    rng = np.random.default_rng(12)
    n_feat, d = 100, 32
    p = rng.normal(size=(n_feat, d)).astype(np.float32)
    p_ext = np.concatenate([p, np.zeros((1, d), np.float32)])
    hits = np.full((5, 24), n_feat, dtype=np.int32)
    rows = []
    for r in range(5):
        n = rng.integers(0, 20)
        feat = np.sort(rng.choice(n_feat, size=n, replace=False)).astype(np.int32)
        hits[r, : len(feat)] = feat
        rows.append(feat)
    e = np.asarray(embed_hits(jnp.asarray(hits), jnp.asarray(p_ext), hit_chunk=7))
    for r in range(5):
        expect = p[rows[r]].sum(axis=0) if len(rows[r]) else np.zeros(d)
        assert np.allclose(e[r], expect, rtol=1e-5, atol=1e-5)


def test_knn_exact_matches_oracle():
    rng = np.random.default_rng(13)
    e = rng.normal(size=(100, 32)).astype(np.float32)
    e[7] = 0  # zero row must not crash or produce NaN
    idx_d, dist_d = knn_exact(e, 10, query_tile=16, precision="fp32")
    idx_o, dist_o = oracle.knn_cosine(e, 10)
    assert not np.any(np.isnan(dist_d))
    # distances agree within fp tolerance at each rank
    assert np.allclose(dist_d, dist_o, atol=2e-4)
    # neighbor sets agree except possible boundary ties
    for r in range(100):
        inter = len(set(idx_d[r]) & set(idx_o[r]))
        assert inter >= 9, f"row {r}: {inter}"


def test_knn_exact_streamed_matches_unstreamed():
    """The query-slab streaming path (stream_rows < N, used to overlap the
    device->host result copy with compute and to bound single-transfer
    size at the chr1 rung) must return exactly what the one-shot path
    returns, including the non-multiple final slab."""
    rng = np.random.default_rng(15)
    e = rng.normal(size=(200, 32)).astype(np.float32)
    idx_one, dist_one = knn_exact(e, 10, query_tile=16, precision="fp32")
    idx_s, dist_s = knn_exact(e, 10, query_tile=16, precision="fp32",
                              stream_rows=64)
    np.testing.assert_array_equal(idx_s, idx_one)
    np.testing.assert_allclose(dist_s, dist_one, atol=1e-6)
    # u16 wire through the streamed path too
    idx_u, dist_u = knn_exact(e, 10, query_tile=16, precision="fp32",
                              stream_rows=96, transfer="u16")
    np.testing.assert_array_equal(idx_u, idx_one)
    np.testing.assert_allclose(dist_u, dist_one, atol=2e-4)


def test_knn_bf16_close_to_fp32():
    rng = np.random.default_rng(14)
    e = rng.normal(size=(256, 128)).astype(np.float32)
    idx16, d16 = knn_exact(e, 5, precision="bf16")
    idx32, d32 = knn_exact(e, 5, precision="fp32")
    assert np.allclose(d16, d32, atol=2e-2)
    agree = np.mean([len(set(a) & set(b)) / 5 for a, b in zip(idx16, idx32)])
    assert agree > 0.9


@pytest.mark.parametrize("k", [13, 21])
def test_read_hits_indexed_matches_plain(k):
    """Prefix-table fast path must agree exactly with the plain search."""
    from fedrann_jax.kmers.membership import build_library_index

    sim = simulate_reads(genome_length=6000, coverage=5, mean_read_length=800,
                         seed=8)
    lib = _mk_library(sim, k)
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(2048,),
    )
    bases = jnp.asarray(packed.buckets[0].bases)
    index = build_library_index(lib.codes, k)
    h_fast, n_fast, d_fast = read_hits(bases, index, k, max_hits=2048)
    h_plain, n_plain, d_plain = read_hits(
        bases, library_device_words(lib.codes, k), k, max_hits=2048
    )
    assert np.array_equal(np.asarray(h_fast), np.asarray(h_plain))
    assert np.array_equal(np.asarray(n_fast), np.asarray(n_plain))
    assert np.array_equal(np.asarray(d_fast), np.asarray(d_plain))


def test_embed_hits_pair_matches_mirror_path():
    """swap_halves + shared gather must equal mirror_hits + second embed."""
    from fedrann_jax.project.embed import embed_hits_pair, swap_halves

    rng = np.random.default_rng(20)
    lib_size, d = 50, 16
    p = rng.normal(size=(2 * lib_size + 1, d)).astype(np.float32)
    p[-1] = 0
    sentinel = 2 * lib_size
    hits = np.full((6, 12), sentinel, dtype=np.int32)
    for r in range(6):
        n = rng.integers(0, 10)
        feat = np.sort(rng.choice(2 * lib_size, size=n, replace=False))
        hits[r, :n] = feat
    hits_j = jnp.asarray(hits)
    p_j = jnp.asarray(p)
    e_f, e_r = embed_hits_pair(hits_j, p_j, swap_halves(p_j, lib_size),
                               hit_chunk=5)
    ref_f = embed_hits(hits_j, p_j)
    ref_r = embed_hits(mirror_hits(hits_j, lib_size), p_j)
    assert np.allclose(np.asarray(e_f), np.asarray(ref_f), atol=1e-5)
    assert np.allclose(np.asarray(e_r), np.asarray(ref_r), atol=1e-5)


def test_build_precompute_paired_matches_flat():
    """Paired layout (L+1, 2d) must hold bitwise the same entries as the
    flat (2L+1, d) table: row j = [P[j] | P[j+L]], row L = zeros."""
    from fedrann_jax.project.srp import (
        build_precompute_paired,
        pair_projection,
    )

    counts = np.array([2, 7, 13, 40, 3, 9, 21], dtype=np.int64)
    d, seed = 32, 2094
    flat = np.asarray(build_precompute(jnp.asarray(counts), d, seed, chunk=3,
                                       dtype=jnp.float32))
    paired = np.asarray(build_precompute_paired(
        jnp.asarray(counts), d, seed, chunk=3, dtype=jnp.float32))
    lib = len(counts)
    assert paired.shape == (lib + 1, 2 * d)
    np.testing.assert_array_equal(paired[:lib, :d], flat[:lib])
    np.testing.assert_array_equal(paired[:lib, d:], flat[lib : 2 * lib])
    assert np.all(paired[lib] == 0)
    # host-side re-layout of an imported flat table agrees too
    np.testing.assert_array_equal(pair_projection(flat, xp=np), paired)
    # bf16 chunk-cast path (the production dtype) matches as well
    flat16 = np.asarray(build_precompute(jnp.asarray(counts), d, seed,
                                         chunk=3, dtype=jnp.bfloat16)
                        .astype(jnp.float32))
    paired16 = np.asarray(build_precompute_paired(
        jnp.asarray(counts), d, seed, chunk=3, dtype=jnp.bfloat16)
        .astype(jnp.float32))
    np.testing.assert_array_equal(paired16[:lib, :d], flat16[:lib])
    np.testing.assert_array_equal(paired16[:lib, d:], flat16[lib : 2 * lib])


def test_embed_hits_paired_matches_mirror_path():
    """One 2d-wide gather + half-roll select must equal mirror_hits + a
    second embed pass over the flat table, including rev-feature hits
    (f >= L) and sentinel padding."""
    from fedrann_jax.project.embed import embed_hits_paired
    from fedrann_jax.project.srp import pair_projection

    rng = np.random.default_rng(21)
    lib_size, d = 50, 16
    p = rng.normal(size=(2 * lib_size + 1, d)).astype(np.float32)
    p[-1] = 0
    sentinel = 2 * lib_size
    hits = np.full((6, 12), sentinel, dtype=np.int32)
    for r in range(6):
        n = rng.integers(0, 10)
        feat = np.sort(rng.choice(2 * lib_size, size=n, replace=False))
        hits[r, :n] = feat
    hits_j = jnp.asarray(hits)
    p_j = jnp.asarray(p)
    p_pair = jnp.asarray(pair_projection(p, xp=np))
    e_f, e_r = embed_hits_paired(hits_j, p_pair, lib_size, hit_chunk=5)
    ref_f = embed_hits(hits_j, p_j)
    ref_r = embed_hits(mirror_hits(hits_j, lib_size), p_j)
    assert np.allclose(np.asarray(e_f), np.asarray(ref_f), atol=1e-5)
    assert np.allclose(np.asarray(e_r), np.asarray(ref_r), atol=1e-5)
    # empty-library edge: sentinel-only hits embed to exact zeros
    e0_f, e0_r = embed_hits_paired(
        jnp.zeros((3, 4), jnp.int32), jnp.zeros((1, 2 * d), jnp.float32), 0
    )
    assert np.all(np.asarray(e0_f) == 0) and np.all(np.asarray(e0_r) == 0)


def test_read_hits_hit_buffer_matches_full():
    """Pre-compaction staging buffer must not change results when sized
    adequately."""
    sim = simulate_reads(genome_length=6000, coverage=5, mean_read_length=800,
                         seed=4)
    k = 13
    lib = _mk_library(sim, k, frac=0.2)
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(2048,),
    )
    bases = jnp.asarray(packed.buckets[0].bases)
    lw = library_device_words(lib.codes, k)
    seed, frac = 11, 0.2
    lib_s = oracle.build_library(sim.sequences, k, 2, frac, seed)
    lws = library_device_words(lib_s.codes, k)
    full = read_hits(bases, lws, k, sampling=(seed, frac), hit_buffer=2048)
    small = read_hits(bases, lws, k, sampling=(seed, frac), hit_buffer=512)
    # widths differ (staged width = buffer); found features must not
    sent = 2 * lib_s.size
    hf, hs = np.asarray(full[0]), np.asarray(small[0])
    for r in range(hf.shape[0]):
        assert np.array_equal(np.sort(hf[r][hf[r] != sent]),
                              np.sort(hs[r][hs[r] != sent]))
    assert np.array_equal(np.asarray(full[1]), np.asarray(small[1]))
    # an absurdly small buffer must REPORT drops, not silently lose hits
    tiny = read_hits(bases, lws, k, sampling=(seed, frac), hit_buffer=2)
    assert np.asarray(tiny[2]).sum() > 0


@pytest.mark.parametrize("k", [13, 21])
def test_read_hits_sampling_prefilter_exact(k):
    """Hash prefilter must be an EXACT optimization when the library was
    sampled with the same (seed, fraction)."""
    from fedrann_jax.kmers.membership import build_library_index

    sim = simulate_reads(genome_length=8000, coverage=6, mean_read_length=900,
                         seed=14)
    seed, frac = 77, 0.2
    lib = oracle.build_library(sim.sequences, k, 2, frac, seed)
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(2048,),
    )
    bases = jnp.asarray(packed.buckets[0].bases)
    index = build_library_index(lib.codes, k)
    base = read_hits(bases, index, k, 2048, hit_buffer=2048)
    pref = read_hits(bases, index, k, 2048, hit_buffer=1024,
                     sampling=(seed, frac))
    sent = 2 * lib.size
    hb, hp = np.asarray(base[0]), np.asarray(pref[0])
    for r in range(hb.shape[0]):
        assert np.array_equal(np.sort(hb[r][hb[r] != sent]),
                              np.sort(hp[r][hp[r] != sent])), f"row {r}"
    assert np.array_equal(np.asarray(base[1]), np.asarray(pref[1]))
    assert np.asarray(pref[2]).sum() == 0


@pytest.mark.parametrize("k", [13, 21])
def test_staged_candidates_path_matches_classic(k):
    """stage_candidates + read_hits_staged must equal the classic read_hits
    path exactly (adequately sized buffer)."""
    from fedrann_jax.kmers.membership import (
        build_library_index, read_hits_staged, stage_candidates,
    )

    sim = simulate_reads(genome_length=8000, coverage=6, mean_read_length=900,
                         seed=15)
    seed, frac = 88, 0.25
    lib = oracle.build_library(sim.sequences, k, 2, frac, seed)
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(2048,),
    )
    bases = jnp.asarray(packed.buckets[0].bases)
    index = build_library_index(lib.codes, k)
    classic = read_hits(bases, index, k, 1024, hit_buffer=1024,
                        sampling=(seed, frac))
    seed32 = jnp.uint32(seed)
    thr = jnp.uint32(int(frac * 2**32))
    staged = stage_candidates(bases, k, 1024, False, seed32, thr)
    got = read_hits_staged(staged, index, k)
    assert np.array_equal(np.asarray(classic[0]), np.asarray(got[0]))
    assert np.array_equal(np.asarray(classic[1]), np.asarray(got[1]))


@pytest.mark.parametrize("k", [13, 21])
def test_blocked_selection_matches_full_sort(k):
    """The blocked candidate selection (block_cap set, wide bucket) must
    stage exactly the same candidate multiset as the full-width sort: same
    sorted planes content, same drop counts (zero at 6-sigma capacity), and
    identical downstream feature rows."""
    from fedrann_jax.kmers.membership import (
        SELECT_BLOCK,
        build_library_index,
        read_hits_staged,
        selection_cap,
        stage_candidates,
    )

    # bucket must exceed 2*SELECT_BLOCK for the blocked path to engage
    sim = simulate_reads(genome_length=30000, coverage=3,
                         mean_read_length=3500, seed=21)
    seed, frac = 602, 0.05
    lib = oracle.build_library(sim.sequences, k, 2, frac, seed)
    packed = pack_reads(
        [FastxRecord(n, s) for n, s in zip(sim.names, sim.sequences)],
        length_buckets=(4 * SELECT_BLOCK,),
    )
    bases = jnp.asarray(packed.buckets[0].bases)
    seed32 = jnp.uint32(seed)
    thr = jnp.uint32(int(frac * 2**32))
    hb = 512
    full = stage_candidates(bases, k, hb, False, seed32, thr)
    blocked = stage_candidates(bases, k, hb, False, seed32, thr,
                               block_cap=selection_cap(frac))
    assert blocked[0][0].shape[1] <= hb
    w_b = blocked[0][0].shape[1]
    # the final staged planes are both sorted ascending: the blocked path
    # must agree with the full sort over its (possibly narrower) width
    for pf, pb in zip(full[0], blocked[0]):
        assert np.array_equal(np.asarray(pf)[:, :w_b], np.asarray(pb))
    assert np.array_equal(np.asarray(full[1]), np.asarray(blocked[1]))
    assert np.asarray(blocked[1]).sum() == 0
    index = build_library_index(lib.codes, k)
    h_f = read_hits_staged(full, index, k)
    h_b = read_hits_staged(blocked, index, k)
    sent = 2 * lib.size
    hf, hb_rows = np.asarray(h_f[0]), np.asarray(h_b[0])
    for r in range(hf.shape[0]):
        assert np.array_equal(np.sort(hf[r][hf[r] != sent]),
                              np.sort(hb_rows[r][hb_rows[r] != sent]))
    assert np.array_equal(np.asarray(h_f[1]), np.asarray(h_b[1]))


def test_distance_u16_transfer_roundtrip():
    """u16 wire format: max rounding error bounded by 1/(2*DIST_SCALE) over
    the full [0, 2] cosine-distance range; negatives clip to 0."""
    import jax.numpy as jnp
    import numpy as np

    from fedrann_jax.knn.topk import DIST_SCALE, transfer_dist

    d = np.linspace(-0.001, 2.0, 4097, dtype=np.float32).reshape(1, -1)
    out = transfer_dist(jnp.asarray(d), "u16")
    err = np.abs(out - np.clip(d, 0, 2))
    assert err.max() <= 0.5 / DIST_SCALE + 1e-7, err.max()
    exact = transfer_dist(jnp.asarray(d), "f32")
    assert np.array_equal(exact, d)


@pytest.mark.parametrize("k", [15, 16, 21, 31])
def test_canonical_window_codes_packed_matches_unpacked(k):
    """The O(1)-pass packed-stream codec is bitwise-identical to the
    k-step rolling codec on prefix-valid rows (the bucket layout the
    native packer produces — fastxpack.cpp fastx_fill_bucket_packed)."""
    from fedrann_jax.kmers.codec import canonical_window_codes_packed

    rng = np.random.default_rng(7)
    r, l = 16, 512
    lens = rng.integers(0, l + 1, r).astype(np.int32)
    lens[0], lens[1], lens[2] = l, k - 1, 0
    bases = rng.integers(0, 4, (r, l), dtype=np.uint8)
    col = np.arange(l)[None, :]
    bases_ref = np.where(col < lens[:, None], bases, 4).astype(np.uint8)
    c_ref, f_ref, v_ref = canonical_window_codes(jnp.asarray(bases_ref), k)
    # pack 4 bases/byte LSB-first (padding packs as A), exactly the native
    # packer's layout, then view little-endian uint32
    bases_pk = np.where(col < lens[:, None], bases, 0).astype(np.uint8)
    pk = np.zeros((r, (l + 3) // 4), np.uint8)
    for j in range(l):
        pk[:, j >> 2] |= (bases_pk[:, j] << ((j & 3) * 2)).astype(np.uint8)
    c_pk, f_pk, v_pk = canonical_window_codes_packed(
        jnp.asarray(pk.view("<u4")), jnp.asarray(lens), k, l
    )
    np.testing.assert_array_equal(np.asarray(v_ref), np.asarray(v_pk))
    for a, b in zip(c_ref, c_pk):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    vm = np.asarray(v_ref)
    np.testing.assert_array_equal(np.asarray(f_ref)[vm], np.asarray(f_pk)[vm])


@pytest.mark.parametrize("k", [15, 21])
def test_stage_packed_mode_matches_len_mode(k):
    """pipeline._stage_chunk_fused mode='packed' stages the identical
    candidate planes as the unpack-then-roll 'len' mode."""
    from fedrann_jax.pipeline import _stage_chunk_fused

    rng = np.random.default_rng(11)
    r, l = 16, 512
    lens = rng.integers(k, l + 1, r).astype(np.int32)
    bases = rng.integers(0, 4, (r, l), dtype=np.uint8)
    col = np.arange(l)[None, :]
    bases_pk = np.where(col < lens[:, None], bases, 0).astype(np.uint8)
    pk = np.zeros((r, (l + 3) // 4), np.uint8)
    for j in range(l):
        pk[:, j >> 2] |= (bases_pk[:, j] << ((j & 3) * 2)).astype(np.uint8)
    seed32 = jnp.uint32(602)
    threshold = jnp.uint32(int(0.25 * 2**32))
    args = dict(start=0, rows=r, length=l, k=k, hit_buffer=128,
                keep_all=False, seed32=seed32, threshold=threshold,
                block_cap=None)
    ref = _stage_chunk_fused(
        (jnp.asarray(pk), jnp.asarray(lens)), mode="len", **args)
    got = _stage_chunk_fused(
        (jnp.asarray(pk.view("<u4")), jnp.asarray(lens)), mode="packed",
        **args)
    for a, b in zip(ref[0], got[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(ref[1]), np.asarray(got[1]))


def test_sign_packed_projection_matches_dense():
    """build_precompute_signs reconstructs the f32 dense paired table
    BITWISE, and embed_hits_paired_signs matches embed_hits_paired to fp
    tolerance (the default --projection-dtype signs path: 8x smaller
    table, exact f32 entries)."""
    from fedrann_jax.project.embed import (
        embed_hits_paired,
        embed_hits_paired_signs,
    )
    from fedrann_jax.project.srp import (
        build_precompute_paired,
        build_precompute_signs,
    )

    rng = np.random.default_rng(0)
    lib, d = 3000, 96
    counts = jnp.asarray(rng.integers(2, 50, lib).astype(np.int32))
    p_pair = build_precompute_paired(counts, d, 2094, None,
                                     dtype=jnp.float32)
    signs, mags = build_precompute_signs(counts, d, 2094, None)
    w = signs.shape[1]
    gp = np.asarray(signs)
    fields = (gp[..., None] >> (2 * np.arange(16, dtype=np.uint32))) & 3
    vals = ((fields == 1).astype(np.float32)
            - (fields == 2).astype(np.float32))
    vals = vals.reshape(lib + 1, w * 16)[:, : 2 * d] \
        * np.asarray(mags)[:, None]
    np.testing.assert_array_equal(vals, np.asarray(p_pair))

    hits = rng.integers(0, 2 * lib, (32, 70)).astype(np.int32)
    hits[rng.random((32, 70)) < 0.2] = 2 * lib
    f1, r1 = embed_hits_paired(jnp.asarray(hits), p_pair, lib)
    f2, r2 = embed_hits_paired_signs(jnp.asarray(hits), signs, mags, lib, d)
    np.testing.assert_allclose(np.asarray(f1), np.asarray(f2), atol=1e-5)
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2), atol=1e-5)


@pytest.mark.parametrize("n_rows", [200_000, 1_440_000])
def test_packed_idx_wire_roundtrip(n_rows):
    """The 20/24-bit packed neighbor-index wire (transfer='u16' past the
    uint16 range) is bit-identical to the plain i32 copy, including the
    -1 unset marker (in-band sentinel n_rows)."""
    from fedrann_jax.knn.topk import transfer_idx

    rng = np.random.default_rng(1)
    idx = rng.integers(-1, n_rows, (257, 50)).astype(np.int32)
    out = transfer_idx(jnp.asarray(idx), "u16", n_rows)
    np.testing.assert_array_equal(out, idx)
