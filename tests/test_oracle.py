import numpy as np

from fedrann_jax import oracle
from fedrann_jax.io.fastx import reverse_complement
from fedrann_jax.io.packing import encode_bases
from fedrann_jax.sim import simulate_reads


def test_kmer_code_basic():
    # ACGT with k=2 -> AC=0b0001, CG=0b0110, GT=0b1011
    codes = oracle.kmer_code(encode_bases("ACGT"), 2)
    assert list(codes) == [0b0001, 0b0110, 0b1011]


def test_kmer_code_invalid_windows():
    codes = oracle.kmer_code(encode_bases("ACNGT"), 2)
    sentinel = np.uint64(0xFFFFFFFFFFFFFFFF)
    assert codes[0] != sentinel
    assert codes[1] == sentinel and codes[2] == sentinel
    assert codes[3] != sentinel


def test_revcomp_code_matches_string_revcomp():
    rng = np.random.default_rng(0)
    for k in (3, 15, 21, 31):
        seq = "".join("ACGT"[i] for i in rng.integers(0, 4, size=k))
        code = oracle.kmer_code(encode_bases(seq), k)
        rc_code = oracle.kmer_code(encode_bases(reverse_complement(seq)), k)
        assert oracle.revcomp_code(code, k)[0] == rc_code[0]


def test_canonical_is_strand_invariant():
    rng = np.random.default_rng(1)
    k = 15
    seq = "".join("ACGT"[i] for i in rng.integers(0, 4, size=200))
    fwd = oracle.canonical_code(oracle.kmer_code(encode_bases(seq), k), k)
    rev = oracle.canonical_code(
        oracle.kmer_code(encode_bases(reverse_complement(seq)), k), k
    )
    assert set(map(int, fwd)) == set(map(int, rev))


def test_sample_mask_fraction():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 2**62, size=200_000, dtype=np.uint64)
    frac = 0.05
    mask = oracle.sample_mask(codes, frac, seed=42)
    assert abs(mask.mean() - frac) < 0.005
    # deterministic
    assert np.array_equal(mask, oracle.sample_mask(codes, frac, seed=42))
    # different seed -> different sample
    assert not np.array_equal(mask, oracle.sample_mask(codes, frac, seed=43))


def test_library_multiplicity_filter():
    seqs = ["ACGTACGTACGTACGT", "ACGTACGTACGTACGT", "TTTTTTTTGGGGGGGG"]
    lib = oracle.build_library(seqs, k=5, min_multiplicity=3,
                               sample_fraction=1.0, seed=0)
    # every kept k-mer must occur >= 3 times canonically
    assert np.all(lib.counts >= 3)
    assert np.all(np.diff(lib.codes.astype(np.int64)) > 0)  # sorted unique


def test_mirror_roundtrip():
    feat = np.array([0, 3, 10, 17], dtype=np.int64)
    L = 10
    mirrored = oracle.mirror_indices(feat, L)
    assert np.array_equal(oracle.mirror_indices(mirrored, L), np.sort(feat))


def test_feature_rows_rc_read_equals_mirror():
    """Scanning the reverse-complement sequence must equal the mirrored row
    of the forward scan (the §2.5 contract, made exact by canonical coding)."""
    sim = simulate_reads(genome_length=5000, coverage=4, mean_read_length=800, seed=3)
    lib = oracle.build_library(sim.sequences, k=11, min_multiplicity=2,
                               sample_fraction=0.5, seed=9)
    for seq in sim.sequences[:5]:
        fwd = oracle.read_feature_indices(seq, 11, lib)
        rc_scan = oracle.read_feature_indices(reverse_complement(seq), 11, lib)
        assert np.array_equal(np.sort(oracle.mirror_indices(fwd, lib.size)), rc_scan)


def test_icf_weights():
    lib = oracle.KmerLibrary(
        codes=np.array([5, 9], dtype=np.uint64),
        counts=np.array([2, 7], dtype=np.int64),
    )
    w = oracle.icf_weights(lib)
    assert w.shape == (4,)
    assert np.allclose(w[:2], w[2:])
    assert np.isclose(w[0], np.log(4 / (2 + 1e-12)), rtol=1e-6)


def test_srp_distribution():
    n_features, d = 4096, 128
    m = oracle.srp_matrix(n_features, d, seed=7)
    density = 1.0 / np.sqrt(n_features)
    nonzero = m != 0
    assert abs(nonzero.mean() - density) < density * 0.15
    vals = m[nonzero]
    scale = np.sqrt(1 / density) / np.sqrt(d)
    assert np.allclose(np.abs(vals), scale, rtol=1e-5)
    assert abs((vals > 0).mean() - 0.5) < 0.05
    # deterministic
    assert np.array_equal(m, oracle.srp_matrix(n_features, d, seed=7))


def test_knn_self_at_rank_zero():
    rng = np.random.default_rng(5)
    e = rng.normal(size=(20, 8)).astype(np.float32)
    idx, dist = oracle.knn_cosine(e, 5)
    assert np.array_equal(idx[:, 0], np.arange(20))
    assert np.allclose(dist[:, 0], 0, atol=1e-5)
    assert np.all(np.diff(dist, axis=1) >= -1e-6)


def test_end_to_end_overlap_recovery():
    """Overlapping reads must be each other's near neighbors."""
    sim = simulate_reads(genome_length=20000, coverage=8,
                         mean_read_length=2000, seed=11)
    lib, emb, idx, dist = oracle.run_oracle_pipeline(
        sim.sequences, k=13, sample_fraction=0.3, min_multiplicity=2,
        n_components=128, n_neighbors=10, library_seed=1, projection_seed=2,
    )
    assert emb.shape == (2 * len(sim.sequences), 128)
    truth = sim.truth_overlaps(min_overlap=800)
    assert truth, "simulation should produce overlaps"
    found = 0
    for a, b in truth:
        # a's fwd row is 2a; any orientation of b in its neighbor list counts
        neigh = set(int(t) // 2 for t in idx[2 * a])
        found += (b in neigh)
    recall = found / len(truth)
    assert recall > 0.7, f"oracle recall too low: {recall}"
