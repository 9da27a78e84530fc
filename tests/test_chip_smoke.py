"""chip_smoke.py's phases at tiny sizes on the CPU mesh, and its refusal to
run, or to print a result, without a GPU."""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TINY_SIM = dict(genome_length=20_000, coverage=10, mean_read_length=1500,
                error_rate=0.02, seed=7)
TINY_ARGS = ["-k", "13", "--kmer-sample-fraction", "0.2", "-n", "64",
             "--nndescent-n-neighbors", "40", "--seed", "602",
             "--length-buckets", "4096"]


@pytest.fixture(scope="module")
def sim():
    from fedrann_jax.sim import simulate_reads

    return simulate_reads(**TINY_SIM)


@pytest.fixture(scope="module")
def main_path(sim, tmp_path_factory):
    return cs.phase_main_path(str(tmp_path_factory.mktemp("main")), sim,
                              TINY_ARGS, TINY_SIM["mean_read_length"])


def test_main_path_phase(sim, main_path):
    n = len(sim.names)
    assert main_path["embeddings"].shape == (2 * n, 64)
    assert main_path["library"].size > 0
    assert set(main_path["walls"]) == {"cold", "warm"}


def test_library_phase(sim, tmp_path):
    cs.phase_library(str(tmp_path), sim, 60, TINY_ARGS)


def test_embeddings_phase(sim, main_path):
    cs.phase_embeddings(sim, main_path, TINY_ARGS, n_reads=32)


def test_knn_reference_phase(main_path):
    cs.phase_knn_reference(main_path["embeddings"], 40, n_queries=64)


def test_golden_phase(tmp_path):
    cs.phase_golden(str(tmp_path))


def test_ooc_phase(main_path):
    cs.phase_ooc(main_path["embeddings"], 40, query_tile=64)


def test_four_cards_phase(sim, tmp_path):
    cs.phase_four_cards(str(tmp_path), sim, TINY_ARGS, n_devices=4)


def test_truth_recall_counts_either_direction(sim):
    n = len(sim.names)
    truth = sorted(sim.truth_overlaps(min_overlap=750))
    keys = np.asarray([a * n + b for a, b in truth[::2]], np.int64)
    assert cs.truth_recall(sim, keys, 750) == pytest.approx(
        len(keys) / len(truth))


def test_overlaps_header_checked(tmp_path):
    p = tmp_path / "overlaps.tsv"
    p.write_text("query\ttarget\n")
    with pytest.raises(cs.SmokeFailure):
        cs.read_overlaps(str(p), {"read_0": 0})


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_exits_nonzero_without_gpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, script)],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "reads_per_s" not in out.stdout
