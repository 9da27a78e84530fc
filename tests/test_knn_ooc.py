"""Out-of-core k-NN (knn/ooc.py): exactness vs the in-core path, the
slab/block plan, and the end-to-end pipeline valve (--knn-hbm-budget).

The OOC search is the same tiled exact scan as knn_exact with only the
residency changed, so its results must match the in-core search exactly
(same neighbor sets; distances to bf16-input tolerance)."""

import numpy as np
import pytest

from fedrann_jax.knn.ooc import knn_exact_ooc, plan_ooc
from fedrann_jax.knn.topk import knn_exact


def _emb(n, d, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, 16)).astype(np.float32)
    mix = rng.standard_normal((16, d)).astype(np.float32)
    return base @ mix + 0.25 * rng.standard_normal((n, d)).astype(np.float32)


def _recall(a, b):
    return sum(len(set(a[r]) & set(b[r])) for r in range(len(a))) / a.size


def test_plan_respects_budget():
    budget = 1 << 28  # 256 MB
    k = 50
    q, c = plan_ooc(1_000_000, 512, k, budget)
    assert q % 512 == 0 and q >= 512
    assert (q * 512 * 2 + q * k * 8 + 2 * c * 512 * 2) <= budget + 512 * min(c, 131072) * 4


@pytest.mark.parametrize("n", [700, 5000])
def test_ooc_matches_incore(n):
    emb = _emb(n, 64, seed=n)
    k = 10
    idx_e, dist_e = knn_exact(emb, k, transfer="f32")
    # budget small enough to force several query slabs AND several
    # candidate blocks at this shape
    idx_o, dist_o = knn_exact_ooc(
        emb, k, hbm_budget=1 << 26, block_rows=1024, query_tile=256,
        transfer="f32",
    )
    assert idx_o.shape == idx_e.shape
    # same neighbor sets row-by-row (merge order may permute exact ties)
    assert _recall(idx_o, idx_e) >= 0.999
    assert np.allclose(np.sort(dist_o, 1), np.sort(dist_e, 1), atol=2e-3)
    # self at rank 0 with ~0 distance (output contract)
    assert (idx_o[:, 0] == np.arange(n)).mean() > 0.99


def test_ooc_single_block_path():
    emb = _emb(300, 32, seed=3)
    idx_e, _ = knn_exact(emb, 5, transfer="f32")
    idx_o, _ = knn_exact_ooc(emb, 5, hbm_budget=1 << 30, transfer="f32")
    assert _recall(idx_o, idx_e) >= 0.999


def test_ooc_fp32_exact():
    emb = _emb(900, 48, seed=9)
    idx_e, dist_e = knn_exact(emb, 8, precision="fp32", transfer="f32")
    idx_o, dist_o = knn_exact_ooc(
        emb, 8, hbm_budget=1 << 26, block_rows=512, precision="fp32",
        transfer="f32",
    )
    assert _recall(idx_o, idx_e) >= 0.999
    assert np.allclose(np.sort(dist_o, 1), np.sort(dist_e, 1), atol=1e-5)


def test_pipeline_ooc_budget_matches_incore(tmp_path):
    """--knn-hbm-budget small enough to trip the valve: embed runs in
    host-output mode, the search streams, overlaps match the in-core run."""
    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=120_000, coverage=8,
                         mean_read_length=3000, error_rate=0.03, seed=11)
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)

    def run(extra, name):
        cfg = config_from_args([
            "-i", fasta, "-o", str(tmp_path / name), "-k", "15",
            "--kmer-sample-fraction", "0.05", "-n", "512",
            "--nndescent-n-neighbors", "10", "--seed", "602",
            "--knn-transfer", "f32", *extra,
        ])
        return run_pipeline(cfg)

    base = run([], "out_incore")
    # ~320 reads x d=512: working set 2*320*512*6 ~ 2 MB > 1 MiB budget
    # -> the valve trips (host-mode embed + streamed search)
    ooc = run(["--knn-hbm-budget", "1M"], "out_ooc")
    n, k = base.neighbor_indices.shape
    assert isinstance(ooc.embeddings, np.ndarray)
    hits = sum(
        len(set(ooc.neighbor_indices[r]) & set(base.neighbor_indices[r]))
        for r in range(n)
    )
    assert hits / (n * k) >= 0.999
    # host-resident rows cross the wire in bf16 (the OOC search's own
    # precision — pipeline._embed_chunk_rows): compare at bf16 tolerance
    assert np.allclose(np.asarray(ooc.embeddings, np.float32),
                       np.asarray(base.embeddings), rtol=1e-2, atol=1e-2)


def test_parse_bytes():
    from fedrann_jax.cli import parse_bytes

    assert parse_bytes("8G") == 8 << 30
    assert parse_bytes("512M") == 512 << 20
    assert parse_bytes("512MB") == 512 << 20
    assert parse_bytes("1024") == 1024
    assert parse_bytes(None) is None
    assert parse_bytes("1.5G") == int(1.5 * (1 << 30))


@pytest.mark.parametrize("transfer", ["f32", "u16"])
def test_ivf_ooc_matches_ivf_recall(transfer):
    """knn_ivf_ooc (VERDICT r4 item 4b: sub-quadratic x past-HBM) scores a
    SUPERSET of knn_ivf's probed clusters at the same (C, p, spill), so
    its recall vs exact must be >= the in-core IVF's, the self row keeps
    rank 0, and every returned distance is exact."""
    from fedrann_jax.knn.ivf import knn_ivf
    from fedrann_jax.knn.ooc import knn_ivf_ooc

    n, d = 6000, 64
    emb = _emb(n, d, seed=3)
    k = 10
    idx_e, dist_e = knn_exact(emb, k, transfer="f32")
    idx_i, _ = knn_ivf(emb, k, n_clusters=64, n_probes=8, spill=2,
                       transfer="f32")
    idx_o, dist_o = knn_ivf_ooc(
        emb, k, hbm_budget=1 << 26, n_clusters=64, n_probes=8, spill=2,
        block_rows=1024, query_tile=256, transfer=transfer,
    )
    assert idx_o.shape == idx_e.shape
    r_ivf = _recall(idx_i, idx_e)
    r_ooc = _recall(idx_o, idx_e)
    assert r_ooc >= r_ivf - 1e-9, (r_ooc, r_ivf)
    assert (idx_o[:, 0] == np.arange(n)).mean() > 0.99
    # exact distances on whatever it returns: check against the exact
    # distance of the same (query, target) pairs
    en = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    sample = np.random.default_rng(0).integers(0, n, 200)
    for q in sample:
        for j in range(k):
            t = idx_o[q, j]
            if t < 0:
                continue
            true_d = 1.0 - float(en[q] @ en[t])
            assert abs(float(dist_o[q, j]) - true_d) < 6e-2  # bf16 + u16 wire


def test_ivf_ooc_pipeline_valve(tmp_path):
    """--knn-method ivf composes with --knn-hbm-budget end-to-end (the
    warn-and-override branch is gone)."""
    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=60000, coverage=8,
                         mean_read_length=1500, error_rate=0.02, seed=11)
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)
    out_e = str(tmp_path / "exact")
    base = [
        "-i", fasta, "-k", "13", "--kmer-sample-fraction", "0.2",
        "--kmer-min-multiplicity", "2", "-n", "128",
        "--nndescent-n-neighbors", "10", "--seed", "7",
        "--length-buckets", "2048",
    ]
    exact = run_pipeline(config_from_args(base + ["-o", out_e]))
    out_i = str(tmp_path / "ivf")
    got = run_pipeline(config_from_args(base + [
        "-o", out_i, "--knn-method", "ivf", "--knn-ivf-clusters", "16",
        "--knn-ivf-probes", "16", "--knn-hbm-budget", "4M",
    ]))
    n_rows = exact.neighbor_indices.shape[0]
    # probes == clusters -> every cluster scored: same neighbor sets as
    # exact (up to ties), through the ooc streaming machinery
    r = _recall(got.neighbor_indices, exact.neighbor_indices)
    assert r > 0.99, r
