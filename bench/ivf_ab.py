"""A/B: exact vs IVF k-NN at the bench rungs.

Runs the SAME rung input (reusing the rung workdir's fasta + fxcache)
through the pipeline with --knn-method exact and then ivf at one or more
probe counts, and prints knn-stage seconds, the end-to-end wall, and
neighbor recall of IVF against the exact table as {"ab": "ivf", ...} JSON
rows, also appended to bench/_work/ivf_ab.jsonl (not tracked).

Usage: python bench/ivf_ab.py dmel [ecoli ...] [--probes 8,16]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from configs import CONFIGS  # noqa: E402


def _workdir(cfg):
    work_root = os.environ.get("FEDRANN_BENCH_WORK") or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_work")
    return os.path.join(work_root, cfg.name.split(":")[0])


def run_ab(name: str, probes_list: list[int]) -> list[dict]:
    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.sim import simulate_reads, write_fasta

    cfg = CONFIGS[name]
    tmp = _workdir(cfg)
    os.makedirs(tmp, exist_ok=True)
    fasta = os.path.join(tmp, "reads.fasta")
    if not os.path.exists(fasta):
        sim = simulate_reads(genome_length=cfg.genome, coverage=cfg.coverage,
                             mean_read_length=cfg.read_len,
                             error_rate=cfg.error_rate, seed=1234)
        write_fasta(fasta, sim.names, sim.sequences)

    def run(extra):
        args = [
            "-i", fasta, "-o", os.path.join(tmp, "out"),
            "-k", str(cfg.k),
            "--kmer-sample-fraction", str(cfg.sample_fraction),
            "--kmer-min-multiplicity", str(cfg.min_multiplicity),
            "-n", str(cfg.dim),
            "--nndescent-n-neighbors", str(cfg.n_neighbors),
            "--seed", "602", "--length-buckets", cfg.length_buckets_arg(),
            "--threads", "4", *extra,
        ]
        t0 = time.perf_counter()
        result = run_pipeline(config_from_args(args))
        return result, time.perf_counter() - t0

    # warm pass (compiles + fxcache), then the timed exact run. Results
    # are stripped to host arrays IMMEDIATELY: PipelineResult.embeddings
    # is a device-resident (2R, d) matrix (2.95 GB at the chr1 rung), and
    # holding the exact pass's copy across the IVF passes OOM'd the chip.
    run(["--knn-method", "exact"])
    exact, wall_e = run(["--knn-method", "exact"])
    idx_e = np.asarray(exact.neighbor_indices)
    knn_e = exact.metrics["knn"]["seconds"]
    del exact
    n, k = idx_e.shape

    rows = []
    for p in probes_list:
        ivf_args = ["--knn-method", "ivf", "--knn-ivf-probes", str(p)]
        run(ivf_args)  # warm (ivf compiles)
        ivf, wall_i = run(ivf_args)
        idx_i = np.asarray(ivf.neighbor_indices)
        knn_i = ivf.metrics["knn"]["seconds"]
        del ivf
        recall = sum(
            len(set(idx_i[r]) & set(idx_e[r])) for r in range(n)
        ) / (n * k)
        row = {
            "ab": "ivf",
            "config": cfg.name,
            "n_reads": n // 2,
            "n_rows": n,
            "probes": p,
            "knn_exact_s": round(knn_e, 2),
            "knn_ivf_s": round(knn_i, 2),
            "knn_speedup": round(knn_e / knn_i, 2) if knn_i else None,
            "wall_exact_s": round(wall_e, 2),
            "wall_ivf_s": round(wall_i, 2),
            "neighbor_recall_vs_exact": round(recall, 4),
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        print(json.dumps(row), flush=True)
        # append IMMEDIATELY: a later probe's failure (e.g. OOM at a
        # bigger p) must not lose the rows already measured
        results_dir = os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "_work")
        os.makedirs(results_dir, exist_ok=True)
        with open(os.path.join(results_dir, "ivf_ab.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")
        rows.append(row)
    return rows


def main(argv):
    probes = [8, 16]
    names = []
    i = 0
    while i < len(argv):
        if argv[i] == "--probes":
            probes = [int(x) for x in argv[i + 1].split(",")]
            i += 2
        else:
            names.append(argv[i])
            i += 1
    for name in names or ["dmel"]:
        run_ab(name, probes)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
