"""Ultra-long reads are chunk-split and merged back exactly.

VERDICT r1 missing item 6: reads longer than the largest length bucket
were silently truncated while the reference streams unbounded lengths
(fastx_io.py:158-183). The pipeline now splits them into k-1-overlapped
segments at pack time and merges an exact per-read hit UNION at embed
time — the embedding of a 100 kb+ read must equal the oracle's
whole-read embedding bit-for-tolerance."""

from __future__ import annotations

import numpy as np
import pytest

from fedrann_jax import oracle
from fedrann_jax.cli import config_from_args
from fedrann_jax.io.fastx import FastxRecord
from fedrann_jax.io.packing import pack_reads, segment_spans
from fedrann_jax.pipeline import run_pipeline
from fedrann_jax.sim import simulate_reads, write_fasta

K = 13
BUCKETS = "2048,16384"


@pytest.fixture(scope="module")
def long_read_input(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("split")
    sim = simulate_reads(genome_length=120_000, coverage=4,
                         mean_read_length=2500, error_rate=0.02, seed=11)
    rng = np.random.default_rng(5)
    # one read spanning a large chunk of the genome: overlaps many short
    # reads and is ~6x the largest bucket
    start = 5_000
    long_seq = sim.genome[start : start + 100_000]
    names = list(sim.names) + ["long_read"]
    seqs = list(sim.sequences) + [long_seq]
    path = str(tmp / "reads.fasta")
    write_fasta(path, names, seqs)
    return names, seqs, path, tmp


def test_packer_splits_not_truncates(long_read_input):
    names, seqs, path, tmp = long_read_input
    packed = pack_reads(
        (FastxRecord(n, s) for n, s in zip(names, seqs)),
        length_buckets=(2048, 16384), split_overlap=K - 1,
    )
    assert packed.n_truncated == 0
    assert packed.split_read_ids is not None
    assert list(packed.split_read_ids) == [len(names) - 1]
    spans = segment_spans(100_000, 16384, K - 1)
    assert sum(1 for b in packed.buckets
               for i in b.read_index if i == len(names) - 1) == len(spans)
    # every window of the long read appears in exactly one segment
    covered = sorted(
        (s, s + ln - K + 1) for s, ln in spans
    )
    expect = 0
    for s, e in covered:
        assert s == expect
        expect = e
    assert expect == 100_000 - K + 1


def test_split_read_matches_oracle_end_to_end(long_read_input, tmp_path):
    names, seqs, path, _ = long_read_input
    config = config_from_args([
        "-i", path, "-o", str(tmp_path / "o"), "-k", str(K),
        "--kmer-sample-fraction", "0.2", "--kmer-min-multiplicity", "2",
        "-n", "128", "--nndescent-n-neighbors", "10", "--seed", "602",
        "--length-buckets", BUCKETS,
        "--projection-dtype", "f32",  # fp-exact vs the oracle
    ])
    result = run_pipeline(config)

    lib_o, emb_o, idx_o, _ = oracle.run_oracle_pipeline(
        seqs, k=K, sample_fraction=0.2, min_multiplicity=2,
        n_components=128, n_neighbors=10, library_seed=602,
        projection_seed=2094,
    )
    assert np.array_equal(result.library.codes, lib_o.codes)
    # all rows — including the split read's fwd/rev pair — match the
    # whole-read oracle embeddings
    assert np.allclose(result.embeddings, emb_o, rtol=1e-4, atol=1e-4)
    long_rows = (2 * (len(names) - 1), 2 * (len(names) - 1) + 1)
    for row in long_rows:
        assert np.linalg.norm(result.embeddings[row]) > 0
    agree = np.mean([
        len(set(a) & set(b)) / len(b)
        for a, b in zip(result.neighbor_indices, idx_o)
    ])
    assert agree > 0.95, f"neighbor agreement {agree}"
