import numpy as np
import pytest

from fedrann_jax import oracle
from fedrann_jax.compat import load_reference_library, load_reference_precompute
from fedrann_jax.eval import OverlapTable, neighbor_recall, truth_recall


def _write_overlaps(path, rows):
    with open(path, "w") as f:
        f.write("query_name\tquery_orientation\ttarget_name\ttarget_orientation"
                "\tneighbor_rank\tdistance\n")
        for r in rows:
            f.write("\t".join(map(str, r)) + "\n")


def test_neighbor_recall_identical(tmp_path):
    rows = [
        ("r0", "+", "r1", "-", 1, 0.1),
        ("r0", "+", "r2", "+", 2, 0.2),
        ("r1", "-", "r0", "+", 1, 0.1),
    ]
    a = tmp_path / "a.tsv"
    _write_overlaps(a, rows)
    t = OverlapTable.read(str(a))
    rep = neighbor_recall(t, t)
    assert rep.recall_at_k == 1.0
    assert rep.query_coverage == 1.0
    assert rep.distance_mae == 0.0


def test_neighbor_recall_partial(tmp_path):
    ref_rows = [
        ("r0", "+", "r1", "-", 1, 0.1),
        ("r0", "+", "r2", "+", 2, 0.2),
    ]
    cand_rows = [
        ("r0", "+", "r1", "-", 1, 0.15),
        ("r0", "+", "r9", "+", 2, 0.2),
    ]
    a, b = tmp_path / "a.tsv", tmp_path / "b.tsv"
    _write_overlaps(a, ref_rows)
    _write_overlaps(b, cand_rows)
    rep = neighbor_recall(OverlapTable.read(str(a)), OverlapTable.read(str(b)))
    assert rep.recall_at_k == pytest.approx(0.5)
    assert rep.distance_mae == pytest.approx(0.05)
    # orientation-insensitive matching
    cand2 = [("r0", "+", "r1", "+", 1, 0.1), ("r0", "+", "r2", "-", 2, 0.2)]
    c = tmp_path / "c.tsv"
    _write_overlaps(c, cand2)
    rep2 = neighbor_recall(OverlapTable.read(str(a)), OverlapTable.read(str(c)),
                           match_orientation=False)
    assert rep2.recall_at_k == 1.0


def test_overlap_table_bad_header(tmp_path):
    p = tmp_path / "bad.tsv"
    p.write_text("a\tb\n")
    with pytest.raises(ValueError):
        OverlapTable.read(str(p))


def test_truth_recall():
    # 3 reads (6 rows); read0 <-> read1 linked, read2 isolated
    idx = np.array([
        [0, 2], [1, 3], [2, 0], [3, 1], [4, 5], [5, 4],
    ])
    assert truth_recall(idx, {(0, 1)}, 3) == 1.0
    assert truth_recall(idx, {(0, 1), (0, 2)}, 3) == 0.5


def test_load_reference_library(tmp_path):
    """jellyfish-dump format: >count then the canonical k-mer."""
    p = tmp_path / "lib.fasta"
    p.write_text(">5\nACGTA\n>2\nAAAAA\n>9\nTTT\n")  # TTT wrong length: skipped
    lib = load_reference_library(str(p), k=5)
    assert lib.size == 2
    assert np.all(np.diff(lib.codes.astype(np.int64)) > 0)
    code_aaaaa = oracle.kmer_code(
        np.zeros(5, dtype=np.uint8), 5
    )[0]
    assert lib.codes[0] == code_aaaaa
    assert lib.counts[0] == 2  # AAAAA's count


def test_load_reference_precompute(tmp_path):
    import scipy.sparse as sp

    m = sp.random(20, 8, density=0.3, format="csr", dtype=np.float32,
                  random_state=0)
    path = tmp_path / "p.npz"
    sp.save_npz(path, m)
    p = load_reference_precompute(str(path))
    assert p.shape == (21, 8)
    assert np.allclose(p[:20], m.toarray())
    assert np.all(p[20] == 0)


def test_pipeline_with_imported_library_and_projection(tmp_path):
    """Golden-parity flags: feeding the pipeline a reference-format library
    + projection must reproduce oracle embeddings built from the same."""
    import scipy.sparse as sp

    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=8000, coverage=5,
                         mean_read_length=900, seed=53)
    k = 13
    lib = oracle.build_library(sim.sequences, k, 2, 0.4, seed=7)
    # write the library in jellyfish-dump format (reference artifact shape)
    lib_fa = tmp_path / "fwd_kmer_library.fasta"
    def decode(code):
        return "".join("ACGT"[(int(code) >> (2 * (k - 1 - i))) & 3]
                       for i in range(k))
    with open(lib_fa, "w") as f:
        for c, n in zip(lib.codes, lib.counts):
            f.write(f">{n}\n{decode(c)}\n")
    # reference-style precompute: dense SRP x ICF as a scipy sparse npz
    p = oracle.srp_matrix(lib.n_features, 32, seed=99) * \
        oracle.icf_weights(lib)[:, None]
    npz = tmp_path / "precompute.npz"
    sp.save_npz(npz, sp.csr_matrix(p))

    reads = tmp_path / "r.fasta"
    write_fasta(str(reads), sim.names, sim.sequences)
    config = config_from_args([
        "-i", str(reads), "-o", str(tmp_path / "o"), "-k", str(k),
        "--kmer-sample-fraction", "0.4", "--seed", "7",
        "--nndescent-n-neighbors", "5",
        "--import-library", str(lib_fa),
        "--import-projection", str(npz),
        "--length-buckets", "2048", "--knn-query-tile", "64",
    ])
    result = run_pipeline(config)
    assert np.array_equal(result.library.codes, lib.codes)
    rows = oracle.feature_rows(sim.sequences, k, lib)
    expect = np.zeros((2 * len(sim.sequences), 32), np.float32)
    p_np = np.asarray(p, np.float32)
    for r, feat in enumerate(rows):
        if len(feat):
            expect[r] = p_np[feat].sum(axis=0)
    assert np.allclose(np.asarray(result.embeddings), expect,
                       rtol=1e-4, atol=1e-4)


def test_import_projection_shape_mismatch(tmp_path):
    import scipy.sparse as sp

    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=5000, coverage=4,
                         mean_read_length=700, seed=54)
    reads = tmp_path / "r.fasta"
    write_fasta(str(reads), sim.names, sim.sequences)
    npz = tmp_path / "bad.npz"
    sp.save_npz(npz, sp.csr_matrix(np.ones((6, 8), np.float32)))
    config = config_from_args([
        "-i", str(reads), "-o", str(tmp_path / "o"), "-k", "11",
        "--kmer-sample-fraction", "0.5", "--seed", "3",
        "--import-projection", str(npz), "--length-buckets", "2048",
    ])
    with pytest.raises(ValueError, match="feature rows"):
        run_pipeline(config)


def test_import_library_not_hash_sampled_still_hits(tmp_path):
    """Regression: an imported library sampled by a DIFFERENT process than
    our hash (e.g. the reference's awk rand()) must not be starved by the
    membership sampling prefilter."""
    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=8000, coverage=5,
                         mean_read_length=900, seed=55)
    k = 13
    # library sampled with seed 999 but the pipeline runs with --seed 7:
    # hash-prefiltering with seed 7 would silently drop most of these codes
    lib = oracle.build_library(sim.sequences, k, 2, 0.3, seed=999)
    lib_fa = tmp_path / "lib.fasta"
    def decode(code):
        return "".join("ACGT"[(int(code) >> (2 * (k - 1 - i))) & 3]
                       for i in range(k))
    with open(lib_fa, "w") as f:
        for c, n in zip(lib.codes, lib.counts):
            f.write(f">{n}\n{decode(c)}\n")
    reads = tmp_path / "r.fasta"
    write_fasta(str(reads), sim.names, sim.sequences)
    config = config_from_args([
        "-i", str(reads), "-o", str(tmp_path / "o"), "-k", str(k),
        "--kmer-sample-fraction", "0.3", "--seed", "7",
        "--nndescent-n-neighbors", "5", "--import-library", str(lib_fa),
        "--length-buckets", "2048", "--knn-query-tile", "64", "-n", "64",
        "--projection-dtype", "f32",  # fp-exact vs the oracle
    ])
    result = run_pipeline(config)
    rows = oracle.feature_rows(sim.sequences, k, lib)
    emb_o = oracle.embed(rows, lib, 64, 2094)
    assert np.allclose(np.asarray(result.embeddings), emb_o,
                       rtol=1e-4, atol=1e-4)
    assert np.abs(np.asarray(result.embeddings)).sum() > 0


def test_eval_cli(tmp_path, capsys):
    from fedrann_jax.eval import main

    t = tmp_path / "a.tsv"
    header = ("query_name\tquery_orientation\ttarget_name\t"
              "target_orientation\tneighbor_rank\tdistance\n")
    t.write_text(header + "r0\t+\tr1\t+\t1\t0.25\n")
    rc = main([str(t), str(t)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "recall@k=1.0000" in out
