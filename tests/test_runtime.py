"""Multi-host partitioning and library-merge semantics (single process)."""

import numpy as np

from fedrann_jax import oracle
from fedrann_jax.parallel.runtime import (
    host_read_range,
    merge_library_shards,
    partition_counts_threshold,
)
from fedrann_jax.sim import simulate_reads


def test_host_read_range_covers_all():
    for n, h in [(10, 3), (8, 8), (5, 8), (100, 7), (0, 4)]:
        got = []
        for p in range(h):
            s, e = host_read_range(n, p, h)
            got.extend(range(s, e))
        assert got == list(range(n)), (n, h)


def test_merged_shards_equal_global_library():
    """Per-host libraries (min_mult=1) merged + global threshold must equal
    the single-host library built over all reads."""
    sim = simulate_reads(genome_length=12000, coverage=8,
                         mean_read_length=900, seed=51)
    k, frac, seed, min_mult = 13, 0.4, 77, 2
    n_hosts = 3
    shards = []
    for p in range(n_hosts):
        s, e = host_read_range(len(sim.sequences), p, n_hosts)
        shards.append(
            oracle.build_library(sim.sequences[s:e], k, 1, frac, seed)
        )
    merged = partition_counts_threshold(shards, min_mult)
    ref = oracle.build_library(sim.sequences, k, min_mult, frac, seed)
    assert np.array_equal(merged.codes, ref.codes)
    assert np.array_equal(merged.counts, ref.counts)


def test_merge_single_shard_identity():
    lib = oracle.KmerLibrary(
        codes=np.array([3, 9], np.uint64), counts=np.array([4, 5], np.int64)
    )
    out = merge_library_shards([lib])
    assert out is lib


def test_multihost_driver_single_process_identity(tmp_path):
    """With one process, run_pipeline_multihost must equal run_pipeline."""
    from fedrann_jax.cli import config_from_args
    from fedrann_jax.parallel.runtime import run_pipeline_multihost
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.sim import write_fasta

    sim = simulate_reads(genome_length=10000, coverage=5,
                         mean_read_length=1000, seed=52)
    path = str(tmp_path / "r.fasta")
    write_fasta(path, sim.names, sim.sequences)
    args = ["-i", path, "-o", str(tmp_path / "o"), "-k", "13",
            "--kmer-sample-fraction", "0.3", "-n", "64",
            "--nndescent-n-neighbors", "5", "--seed", "9",
            "--length-buckets", "2048", "--knn-query-tile", "64"]
    r_multi = run_pipeline_multihost(config_from_args(args))
    r_single = run_pipeline(config_from_args(
        args[:3] + [str(tmp_path / "o2")] + args[4:]
    ))
    assert np.array_equal(r_multi.library.codes, r_single.library.codes)
    assert np.array_equal(r_multi.neighbor_indices, r_single.neighbor_indices)
