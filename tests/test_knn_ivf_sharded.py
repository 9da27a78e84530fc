"""Cluster-sharded IVF k-NN (knn_ivf_sharded) over the 8-device CPU mesh.

Mirrors tests/test_sharded_knn.py for the sub-quadratic path (VERDICT r3
item 3b): the IVF valve must compose with the mesh instead of falling back
to exact. Recall is judged against the single-device EXACT search — the
sharded k-means may differ from the single-device one in fp reduction
order (psum'ed segment sums), so bitwise equality with knn_ivf is not the
contract; matching exact-search recall on clustered data is.
"""

import jax
import numpy as np
import pytest

from fedrann_jax.knn.ivf import knn_ivf_sharded
from fedrann_jax.knn.topk import knn_exact
from fedrann_jax.parallel.mesh import make_mesh

from test_knn_ivf import _clustered_embeddings


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh()


def test_recall_vs_exact_on_clustered_data(mesh):
    rng = np.random.default_rng(11)
    e = _clustered_embeddings(6000, 64, 40, rng)
    k = 20
    idx_i, dist_i = knn_ivf_sharded(e, k, mesh=mesh, n_clusters=64,
                                    n_probes=8, precision="fp32")
    idx_e, _ = knn_exact(e, k, precision="fp32")
    hits = sum(
        len(set(idx_i[r]) & set(idx_e[r])) for r in range(len(e))
    )
    recall = hits / (len(e) * k)
    assert recall >= 0.98, recall
    # rescore contract: every returned distance is the exact cosine
    en = e / np.linalg.norm(e, axis=1, keepdims=True)
    for r in (0, 123, 4567):
        true = 1.0 - en[r] @ en[idx_i[r]].T
        assert np.allclose(dist_i[r], true, atol=1e-4), r


def test_recall_on_real_read_geometry(mesh):
    """IVF recall on READ embeddings, not Gaussian blobs (VERDICT r4 weak
    7): read embeddings lie on the genome's 1-D overlap manifold, where
    k-means boundaries cut true neighbor pairs — exactly where blob tests
    are least informative. The oracle builds the embeddings (golden
    semantics, CPU); floors are from the measured round-5 probe on this
    exact shape (0.7947 at p=8, 0.9071 at p=16, sharded == single-device
    bit-for-bit). The sharded path must add NO approximation beyond the
    IVF itself."""
    from fedrann_jax import oracle
    from fedrann_jax.knn.ivf import knn_ivf
    from fedrann_jax.sim import simulate_reads

    sim = simulate_reads(genome_length=200_000, coverage=8,
                         mean_read_length=2000, error_rate=0.05, seed=5)
    lib = oracle.build_library(sim.sequences, 15, 2, 0.1, 602)
    rows = oracle.feature_rows(sim.sequences, 15, lib)
    emb = oracle.embed(rows, lib, 128, 2094)
    assert emb.shape[0] == 2 * len(sim.sequences)

    k = 20
    idx_e, _ = knn_exact(emb, k, precision="fp32")

    def recall(idx):
        hits = sum(
            len(set(idx[r]) & set(idx_e[r])) for r in range(len(emb))
        )
        return hits / (len(emb) * k)

    floors = {8: 0.72, 16: 0.85}
    for probes, floor in floors.items():
        idx_i, _ = knn_ivf(emb, k, n_clusters=64, n_probes=probes,
                           precision="fp32")
        r_single = recall(idx_i)
        idx_s, _ = knn_ivf_sharded(emb, k, mesh=mesh, n_clusters=64,
                                   n_probes=probes, precision="fp32")
        r_shard = recall(idx_s)
        assert r_single >= floor, (probes, r_single)
        # fp reduction order may differ (psum'ed segment sums); parity
        # within noise is the contract, not bitwise equality
        assert r_shard >= r_single - 0.02, (probes, r_shard, r_single)


def test_self_at_rank_zero_and_valid_indices(mesh):
    # 5003 rows: NOT divisible by 8 — exercises the row padding, the
    # padded-member masking, and the out-of-bounds sentinel drops
    rng = np.random.default_rng(13)
    e = _clustered_embeddings(5003, 32, 25, rng)
    idx_i, dist_i = knn_ivf_sharded(e, 8, mesh=mesh, n_clusters=32,
                                    n_probes=4, precision="fp32")
    assert idx_i.shape == (5003, 8)
    assert np.array_equal(idx_i[:, 0], np.arange(5003))
    assert np.allclose(dist_i[:, 0], 0.0, atol=1e-5)
    assert idx_i.max() < 5003 and idx_i.min() >= 0
    assert (np.diff(dist_i, axis=1) >= -1e-6).all()


def test_small_n_falls_back_to_sharded_exact(mesh):
    rng = np.random.default_rng(7)
    e = rng.normal(size=(300, 32)).astype(np.float32)
    idx_i, dist_i = knn_ivf_sharded(e, 10, mesh=mesh, precision="fp32")
    idx_e, dist_e = knn_exact(e, 10, precision="fp32")
    assert np.allclose(dist_i, dist_e, atol=1e-4)
    for r in range(300):
        assert len(set(idx_i[r]) & set(idx_e[r])) >= 9, r


def test_cluster_count_rounds_to_device_multiple(mesh):
    # n_clusters=20 is not a multiple of 8 devices; the search must round
    # it up and still satisfy the output contract
    rng = np.random.default_rng(17)
    e = _clustered_embeddings(4096, 32, 20, rng)
    idx_i, dist_i = knn_ivf_sharded(e, 5, mesh=mesh, n_clusters=20,
                                    n_probes=4, precision="fp32")
    assert np.array_equal(idx_i[:, 0], np.arange(4096))
    assert idx_i.max() < 4096 and idx_i.min() >= 0
