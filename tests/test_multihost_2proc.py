"""Two-process multi-host run (real jax.distributed over CPU) vs the
single-process pipeline on the same dataset.

VERDICT r1 weak item 4 / next-round item 4: the nproc>1 branch of
run_pipeline_multihost was never executed by any test. Here two
subprocesses launch with --num-processes/--process-id/--coordinator (the
CLI wiring), each owning half the reads; the merged rank files must agree
with the single-process run:

- the global library is bit-identical (hash sampling is order-free and the
  count merge re-applies the threshold globally),
- every read's neighbor list matches the single-process result at
  recall ~1 with tiny distance error (tiling/accumulation order differs,
  so near-ties may swap — exact bitwise match is not the contract the
  reference itself meets across thread counts either, SURVEY.md §2.4).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DRIVER = r"""
import os, sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_cpu_collectives_implementation", "gloo")
from fedrann_jax.cli import main
sys.exit(main([
    "-i", {fasta!r}, "-o", {out!r},
    "-k", "13", "--kmer-sample-fraction", "0.2",
    "--kmer-min-multiplicity", "2", "-n", "128",
    "--nndescent-n-neighbors", "10", "--seed", "7",
    "--length-buckets", "1024,2048",
    "--num-processes", "2", "--process-id", {rank!r},
    "--coordinator", {coord!r},
]))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
@pytest.mark.parametrize("dcn_knn", ["ring", "ring2d", "host"])
def test_two_process_matches_single(tmp_path, dcn_knn):
    from fedrann_jax.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=20000, coverage=6,
                         mean_read_length=1800, error_rate=0.02, seed=7)
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)

    # single-process truth (in-process, CPU mesh from conftest). The
    # 1024/2048 buckets force several ~1800-3000 bp reads to chunk-split,
    # so this also covers the multi-host ultra-long-read path (VERDICT r2
    # item 5: reads longer than the largest bucket were silently truncated
    # under --num-processes).
    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline

    out_single = str(tmp_path / "single")
    config = config_from_args([
        "-i", fasta, "-o", out_single, "-k", "13",
        "--kmer-sample-fraction", "0.2", "--kmer-min-multiplicity", "2",
        "-n", "128", "--nndescent-n-neighbors", "10", "--seed", "7",
        "--length-buckets", "1024,2048",
    ])
    single = run_pipeline(config)
    assert any(len(s) > 2048 for s in sim.sequences), \
        "dataset must contain a read longer than the largest bucket"

    # two real processes over a jax.distributed CPU coordinator
    coord = f"127.0.0.1:{_free_port()}"
    out_multi = str(tmp_path / "multi")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)  # 1 CPU device per process
    # "ring" = device-resident global-mesh search (the default wired path);
    # "host" = the all-gather-to-host fallback
    env["FEDRANN_JAX_MULTIHOST_KNN"] = dcn_knn
    procs = []
    for rank in range(2):
        code = DRIVER.format(repo=REPO, fasta=fasta, out=out_multi,
                             rank=str(rank), coord=coord)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]

    # rank 0 merged the rank tables into ONE overlaps.tsv (and removed the
    # rank files — keep-intermediates not set); it must match the
    # single-process table (neighbor sets + distances)
    from fedrann_jax.eval import OverlapTable, neighbor_recall

    merged = os.path.join(out_multi, "overlaps.tsv")
    assert os.path.exists(merged), outs[0][-2000:]
    for rank in range(2):
        assert not os.path.exists(
            os.path.join(out_multi, f"overlaps.rank{rank}.tsv"))
    ref = OverlapTable.read(os.path.join(out_single, "overlaps.tsv"))
    got = OverlapTable.read(merged)
    rep = neighbor_recall(ref, got)
    assert rep.query_coverage == 1.0, rep
    assert rep.recall_at_k > 0.995, rep
    assert rep.distance_mae < 1e-3, rep

    # the operational story runs on this path too: per-rank stage metrics
    # (observability) exist and cover the full stage set
    import json

    for rank in range(2):
        mpath = os.path.join(out_multi, f"metrics.rank{rank}.json")
        assert os.path.exists(mpath)
        stages = json.load(open(mpath))
        for s in ("load", "stage", "count", "project", "embed", "knn",
                  "output"):
            assert s in stages, (rank, s, stages.keys())


DRIVER_NOCACHE = DRIVER.replace('"--coordinator", {coord!r},',
                                '"--coordinator", {coord!r}, '
                                '"--no-pack-cache",')


@pytest.mark.slow
def test_two_process_byte_range_parse(tmp_path):
    """With pack_cache disabled there is no shared fxcache, so each rank
    takes the byte-range-partitioned load (VERDICT r3 item 8): rank r
    boundary-scans ~1/2 of the file, allgathers offsets+names, and fully
    parses ONLY its own record range — per-rank parse bytes ~ input/ranks
    instead of the old full O(input) re-parse per rank. The merged table
    must still match the single-process run."""
    from fedrann_jax.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=20000, coverage=6,
                         mean_read_length=1800, error_rate=0.02, seed=7)
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)

    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline

    out_single = str(tmp_path / "single")
    config = config_from_args([
        "-i", fasta, "-o", out_single, "-k", "13",
        "--kmer-sample-fraction", "0.2", "--kmer-min-multiplicity", "2",
        "-n", "128", "--nndescent-n-neighbors", "10", "--seed", "7",
        "--length-buckets", "1024,2048",
    ])
    run_pipeline(config)

    coord = f"127.0.0.1:{_free_port()}"
    out_multi = str(tmp_path / "multi")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = []
    for rank in range(2):
        code = DRIVER_NOCACHE.format(repo=REPO, fasta=fasta, out=out_multi,
                                     rank=str(rank), coord=coord)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]

    # each rank logs its parse share; it must be ~half the input, not all
    import re

    for rank, o in enumerate(outs):
        m = re.search(r"byte-range parse:.*\((\d+\.\d)% of input\)", o)
        assert m, (rank, o[-2000:])
        assert float(m.group(1)) < 70.0, m.group(0)

    from fedrann_jax.eval import OverlapTable, neighbor_recall

    merged = os.path.join(out_multi, "overlaps.tsv")
    assert os.path.exists(merged), outs[0][-2000:]
    ref = OverlapTable.read(os.path.join(out_single, "overlaps.tsv"))
    got = OverlapTable.read(merged)
    rep = neighbor_recall(ref, got)
    assert rep.query_coverage == 1.0, rep
    assert rep.recall_at_k > 0.995, rep
    assert rep.distance_mae < 1e-3, rep


DRIVER_CKPT = DRIVER.replace('"--coordinator", {coord!r},',
                             '"--coordinator", {coord!r}, '
                             '"--keep-intermediates",')


@pytest.mark.slow
def test_two_process_checkpoint_resume(tmp_path):
    """Multi-host checkpoint/resume (VERDICT r2 item 7): a second launch
    over the same output dir resumes the global library and each rank's
    embeddings from disk (skipping staging entirely) and reproduces the
    merged table byte-for-byte."""
    from fedrann_jax.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=12000, coverage=5,
                         mean_read_length=1500, error_rate=0.02, seed=11)
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)
    out = str(tmp_path / "multi")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)

    def launch():
        coord = f"127.0.0.1:{_free_port()}"
        procs = []
        for rank in range(2):
            code = DRIVER_CKPT.format(repo=REPO, fasta=fasta, out=out,
                                      rank=str(rank), coord=coord)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            ))
        outs = [p.communicate(timeout=600)[0].decode() for p in procs]
        for p, o in zip(procs, outs):
            assert p.returncode == 0, o[-3000:]
        return outs

    launch()
    ckpt = os.path.join(out, "checkpoints")
    assert os.path.exists(os.path.join(ckpt, "library.npz"))
    for rank in range(2):
        assert os.path.exists(
            os.path.join(ckpt, f"embeddings.rank{rank}.npy"))
    first = open(os.path.join(out, "overlaps.tsv")).read()

    outs = launch()
    assert "resuming library" in outs[0] + outs[1]
    assert "resuming embeddings" in outs[0]
    assert "resuming embeddings" in outs[1]
    # a fully-checkpointed resume never stages candidates on device
    assert "stage stage: start" not in outs[0]
    assert open(os.path.join(out, "overlaps.tsv")).read() == first
    # keep-intermediates retains the per-rank tables
    assert os.path.exists(os.path.join(out, "overlaps.rank0.tsv"))


DRIVER_IVF = DRIVER.replace(
    '"--coordinator", {coord!r},',
    '"--coordinator", {coord!r}, '
    '"--knn-method", "ivf", "--knn-ivf-clusters", "16", '
    '"--knn-ivf-probes", "16",')


@pytest.mark.slow
def test_two_process_ivf(tmp_path):
    """IVF composed with the multi-host runtime (VERDICT r4 item 4a):
    --knn-method ivf under --num-processes 2 runs the cluster-sharded
    rescore over the global mesh (knn_ivf_sharded_multihost). With
    probes == clusters every query rescans every cluster, so the result
    must MATCH the single-process exact table — the test isolates the
    distributed machinery from the probe approximation."""
    from fedrann_jax.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=20000, coverage=6,
                         mean_read_length=1800, error_rate=0.02, seed=7)
    fasta = str(tmp_path / "reads.fasta")
    write_fasta(fasta, sim.names, sim.sequences)

    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline

    out_single = str(tmp_path / "single")
    config = config_from_args([
        "-i", fasta, "-o", out_single, "-k", "13",
        "--kmer-sample-fraction", "0.2", "--kmer-min-multiplicity", "2",
        "-n", "128", "--nndescent-n-neighbors", "10", "--seed", "7",
        "--length-buckets", "1024,2048",
    ])
    run_pipeline(config)

    coord = f"127.0.0.1:{_free_port()}"
    out_multi = str(tmp_path / "multi")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = []
    for rank in range(2):
        code = DRIVER_IVF.format(repo=REPO, fasta=fasta, out=out_multi,
                                 rank=str(rank), coord=coord)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]

    from fedrann_jax.eval import OverlapTable, neighbor_recall

    merged = os.path.join(out_multi, "overlaps.tsv")
    assert os.path.exists(merged), outs[0][-2000:]
    ref = OverlapTable.read(os.path.join(out_single, "overlaps.tsv"))
    got = OverlapTable.read(merged)
    rep = neighbor_recall(ref, got)
    assert rep.query_coverage == 1.0, rep
    assert rep.recall_at_k > 0.995, rep
    assert rep.distance_mae < 1e-3, rep
