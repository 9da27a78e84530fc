"""Sharded k-NN (ring + allgather over the 8-device CPU mesh) vs the
single-device exact search."""

import jax
import numpy as np
import pytest

from fedrann_jax.knn.ring import knn_exact_sharded
from fedrann_jax.knn.topk import knn_exact
from fedrann_jax.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_mesh()


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_sharded_matches_single_device(mesh, strategy):
    rng = np.random.default_rng(31)
    e = rng.normal(size=(200, 64)).astype(np.float32)  # 200 not divisible by 8
    e[11] = 0.0
    idx_s, dist_s = knn_exact_sharded(e, 10, mesh=mesh, strategy=strategy,
                                      precision="fp32")
    idx_1, dist_1 = knn_exact(e, 10, precision="fp32")
    assert idx_s.shape == (200, 10)
    assert np.allclose(dist_s, dist_1, atol=1e-4)
    for r in range(200):
        assert len(set(idx_s[r]) & set(idx_1[r])) >= 9, r
    # no padded (>=200) or unset (-1) indices escape
    assert idx_s.max() < 200 and idx_s.min() >= 0


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_sharded_self_at_rank_zero(mesh, strategy):
    rng = np.random.default_rng(32)
    e = rng.normal(size=(64, 32)).astype(np.float32)
    idx_s, dist_s = knn_exact_sharded(e, 5, mesh=mesh, strategy=strategy,
                                      precision="fp32")
    assert np.array_equal(idx_s[:, 0], np.arange(64))
    assert np.allclose(dist_s[:, 0], 0.0, atol=1e-5)


@pytest.mark.parametrize("n_hosts", [1, 2, 4, 8])
def test_ring2d_matches_single_device(n_hosts):
    """Ring-over-ring on every ("hosts", "data") factorization of the
    8-device mesh == the single-device exact search (the two-level schedule
    must be a pure re-tiling of the same computation)."""
    from fedrann_jax.parallel.mesh import make_mesh_2d

    mesh2 = make_mesh_2d(n_hosts)
    rng = np.random.default_rng(35)
    e = rng.normal(size=(200, 64)).astype(np.float32)
    idx_s, dist_s = knn_exact_sharded(e, 10, mesh=mesh2, strategy="ring2d",
                                      precision="fp32")
    idx_1, dist_1 = knn_exact(e, 10, precision="fp32")
    assert np.allclose(dist_s, dist_1, atol=1e-4)
    for r in range(200):
        assert len(set(idx_s[r]) & set(idx_1[r])) >= 9, r
    assert idx_s.max() < 200 and idx_s.min() >= 0


def test_ring2d_requires_2d_mesh(mesh):
    rng = np.random.default_rng(36)
    e = rng.normal(size=(64, 16)).astype(np.float32)
    with pytest.raises(ValueError, match="ring2d"):
        knn_exact_sharded(e, 4, mesh=mesh, strategy="ring2d")


@pytest.mark.parametrize("strategy", ["ring", "ring2d", "allgather"])
def test_multihost_kernel_single_process(strategy):
    """knn_exact_sharded_multihost in a 1-process launch (process_count=1,
    8 local devices): must reproduce the single-device search with the
    per-process block zero-padding in play (n_reads not a multiple of the
    quota)."""
    from fedrann_jax.knn.ring import knn_exact_sharded_multihost
    from fedrann_jax.parallel.runtime import process_quota

    rng = np.random.default_rng(37)
    n_reads = 93  # odd: forces padding rows inside the block
    e = rng.normal(size=(2 * n_reads, 32)).astype(np.float32)
    per = process_quota(n_reads, 1, row_multiple=8)
    idx_m, dist_m = knn_exact_sharded_multihost(
        e, n_reads, per, 10, strategy=strategy, precision="fp32")
    idx_1, dist_1 = knn_exact(e, 10, precision="fp32")
    assert idx_m.shape == (2 * n_reads, 10)
    assert np.allclose(dist_m, dist_1, atol=1e-4)
    assert idx_m.max() < 2 * n_reads and idx_m.min() >= 0
    for r in range(2 * n_reads):
        assert len(set(idx_m[r]) & set(idx_1[r])) >= 9, r


def test_mesh_smaller_than_devices():
    mesh = make_mesh(shape=(4,))
    rng = np.random.default_rng(33)
    e = rng.normal(size=(50, 16)).astype(np.float32)
    idx_s, dist_s = knn_exact_sharded(e, 4, mesh=mesh, strategy="ring",
                                      precision="fp32")
    idx_1, dist_1 = knn_exact(e, 4, precision="fp32")
    assert np.allclose(dist_s, dist_1, atol=1e-4)


def test_knn_blocked_candidate_tiles_match():
    """Candidate-blocked scan must equal the one-shot search, any tiling."""
    rng = np.random.default_rng(40)
    e = rng.normal(size=(300, 32)).astype(np.float32)
    base_i, base_d = knn_exact(e, 7, query_tile=300, candidate_tile=300,
                               precision="fp32")
    for ct in (16, 64, 128):
        i2, d2 = knn_exact(e, 7, query_tile=50, candidate_tile=ct,
                           precision="fp32")
        assert np.allclose(d2, base_d, atol=1e-5)
        agree = np.mean([len(set(a) & set(b)) / 7 for a, b in zip(i2, base_i)])
        assert agree > 0.98
