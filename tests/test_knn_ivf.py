"""IVF prefilter + exact rescore (knn/ivf.py) vs the exact search.

The IVF path is the sub-quadratic scaling valve (reference analogue:
pynndescent, nearest_neighbors.py:39-55). Its contract: every returned
distance is exact; recall loss comes only from neighbors outside the
probed clusters. On clustered data (which read embeddings are — reads
from the same genome locus share sampled k-mers) recall must be high.
"""

import numpy as np
import pytest

from fedrann_jax.knn.ivf import auto_clusters, knn_ivf
from fedrann_jax.knn.topk import knn_exact


def _clustered_embeddings(n_rows, d, n_centers, rng, spread=0.04):
    """Points around random unit centers — the shape of genome-locus
    embedding clusters. spread is PER-COORDINATE noise sigma; the total
    noise norm is spread*sqrt(d), so 0.04 at d=64 keeps within-cluster
    variation (~0.3) well below the unit center norm — matching real read
    embeddings, where overlapping reads share most sampled k-mers. (On
    isotropic data — spread*sqrt(d) >~ 1 — no partition-based prefilter
    can work: neighbors are spread over arbitrarily many cells.)"""
    centers = rng.normal(size=(n_centers, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    who = rng.integers(0, n_centers, size=n_rows)
    e = centers[who] + spread * rng.normal(size=(n_rows, d))
    return e.astype(np.float32)


def test_small_n_falls_back_to_exact():
    rng = np.random.default_rng(7)
    e = rng.normal(size=(300, 32)).astype(np.float32)
    idx_i, dist_i = knn_ivf(e, 10, precision="fp32")
    idx_e, dist_e = knn_exact(e, 10, precision="fp32")
    assert np.array_equal(idx_i, idx_e)
    assert np.allclose(dist_i, dist_e)


def test_recall_vs_exact_on_clustered_data():
    rng = np.random.default_rng(11)
    e = _clustered_embeddings(6000, 64, 40, rng)
    k = 20
    idx_i, dist_i = knn_ivf(e, k, n_clusters=64, n_probes=8,
                            precision="fp32")
    idx_e, _ = knn_exact(e, k, precision="fp32")
    hits = sum(
        len(set(idx_i[r]) & set(idx_e[r])) for r in range(len(e))
    )
    recall = hits / (len(e) * k)
    assert recall >= 0.98, recall
    # returned distances are EXACT cosine distances (rescore contract):
    # spot-check rows against a dense recompute
    en = e / np.linalg.norm(e, axis=1, keepdims=True)
    for r in (0, 123, 4567):
        true = 1.0 - en[r] @ en[idx_i[r]].T
        assert np.allclose(dist_i[r], true, atol=1e-4), r


def test_self_at_rank_zero_and_valid_indices():
    rng = np.random.default_rng(13)
    e = _clustered_embeddings(5000, 32, 25, rng)
    idx_i, dist_i = knn_ivf(e, 8, n_clusters=32, n_probes=4,
                            precision="fp32")
    assert np.array_equal(idx_i[:, 0], np.arange(5000))
    assert np.allclose(dist_i[:, 0], 0.0, atol=1e-5)
    assert idx_i.max() < 5000 and idx_i.min() >= 0
    # distances sorted ascending per row
    assert (np.diff(dist_i, axis=1) >= -1e-6).all()


def test_more_probes_more_recall():
    rng = np.random.default_rng(17)
    e = _clustered_embeddings(6000, 48, 60, rng, spread=0.08)
    idx_e, _ = knn_exact(e, 10, precision="fp32")

    def recall(p):
        idx_i, _ = knn_ivf(e, 10, n_clusters=64, n_probes=p,
                           precision="fp32")
        return sum(len(set(idx_i[r]) & set(idx_e[r]))
                   for r in range(len(e))) / (len(e) * 10)

    r2, r16 = recall(2), recall(16)
    assert r16 >= r2
    assert r16 >= 0.99, (r2, r16)


def test_auto_clusters_scaling():
    assert auto_clusters(6000) in (128, 256)
    assert auto_clusters(700_000) in (1024, 2048)
    assert auto_clusters(1) == 8


@pytest.mark.parametrize("transfer", ["u16", "f32"])
def test_pipeline_ivf_matches_exact_neighbors(tmp_path, transfer):
    """End-to-end: --knn-method ivf produces (near-)identical overlap
    neighbors to the exact pipeline on a small simulated read set."""
    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=200_000, coverage=8,
                         mean_read_length=4000, error_rate=0.03, seed=5)
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)

    def run(extra):
        cfg = config_from_args([
            "-i", fasta, "-o", str(tmp_path / ("out_" + extra[1])),
            "-k", "15", "--kmer-sample-fraction", "0.05",
            "--kmer-min-multiplicity", "2", "-n", "128",
            "--nndescent-n-neighbors", "10", "--seed", "602",
            "--knn-transfer", transfer, *extra,
        ])
        return run_pipeline(cfg)

    exact = run(["--knn-method", "exact"])
    n_rows = exact.neighbor_indices.shape[0]
    # few hundred rows -> the IVF small-N fallback would kick in at the
    # default cluster count; force a tiny cluster count to exercise the
    # real prefilter path. Under the 8-device test mesh this routes to
    # knn_ivf_sharded (bitwise-identical to knn_ivf — see
    # test_knn_ivf_sharded.py); probing 6/8 clusters bounds the
    # prefilter miss rate enough for the 0.95 bar (4/8 measures 0.92).
    ivf = run(["--knn-method", "ivf", "--knn-ivf-clusters", "8",
               "--knn-ivf-probes", "6"])
    k = exact.neighbor_indices.shape[1]
    hits = sum(
        len(set(ivf.neighbor_indices[r]) & set(exact.neighbor_indices[r]))
        for r in range(n_rows)
    )
    assert hits / (n_rows * k) >= 0.95
