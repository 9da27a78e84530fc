"""Benchmark harness: end-to-end overlap-detection throughput on one GPU.

Prints ONE JSON line:
  {"metric": "reads_per_s", "value": N, "unit": "reads/s", "vs_baseline": R,
   "device_kind": ..., "power_limit": ..., ...}

vs_baseline = device reads/s over the numpy-oracle reads/s on the identical
dataset/config. The oracle implements the reference pipeline's exact
semantics single-threaded on CPU (the reference itself cannot run here:
jellyfish/pynndescent are absent — BASELINE.md says the harness must
produce the CPU baseline itself).

Everything runs in this one process, which holds the card. Without a GPU
the script exits non-zero and prints no result line.

Scale knobs via env: BENCH_GENOME (bp), BENCH_COVERAGE, BENCH_READ_LEN;
BENCH_RUNG=0 skips the dmel rung that follows the primary cell.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time


def power_limit() -> str:
    """The card's power limit as nvidia-smi reports it (a card below its
    maximum runs slower under load, so every number carries it)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench] JAX found no GPU (platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    from fedrann_jax.metrics import device_peaks

    device_peaks(dev)  # a GPU with no published peaks is an error here
    print(f"[bench] device: {dev.device_kind} x {len(jax.devices())}, "
          f"power limit {power_limit()}", file=sys.stderr)
    genome = int(os.environ.get("BENCH_GENOME", 5_000_000))
    coverage = float(os.environ.get("BENCH_COVERAGE", 12))
    read_len = int(os.environ.get("BENCH_READ_LEN", 8000))
    baseline_reads = int(os.environ.get("BENCH_BASELINE_READS", 0))

    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.sim import simulate_reads, write_fasta
    from fedrann_jax import oracle

    sim = simulate_reads(
        genome_length=genome, coverage=coverage, mean_read_length=read_len,
        error_rate=0.05, seed=1234,
    )
    n_reads = len(sim.names)
    print(f"[bench] {n_reads} reads, genome {genome} bp", file=sys.stderr)

    with tempfile.TemporaryDirectory() as tmp:
        fasta = os.path.join(tmp, "reads.fasta")
        write_fasta(fasta, sim.names, sim.sequences)
        args = [
            "-i", fasta, "-o", os.path.join(tmp, "out"),
            "-k", "15", "--kmer-sample-fraction", "0.05",
            "--kmer-min-multiplicity", "2", "-n", "512",
            "--nndescent-n-neighbors", "50", "--seed", "602", "--threads", "4",
            "--length-buckets", "auto",
        ]
        config = config_from_args(args)

        # warm-up run compiles every kernel; BEST of 4 measured runs
        run_pipeline(config)
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            result = run_pipeline(config)
            times.append(time.perf_counter() - t0)
        device_s = min(times)
        device_rps = n_reads / device_s
        print(f"[bench] device: best {device_s:.2f}s of {sorted(times)} = "
              f"{device_rps:.1f} reads/s "
              f"(stages: { {k: round(v['seconds'], 2) for k, v in result.metrics.items()} })",
              file=sys.stderr)
        # roofline view: how the hot stages relate to the card's published
        # peaks (metrics.DEVICE_PEAKS)
        knn_m = result.metrics.get("knn", {})
        embed_m = result.metrics.get("embed", {})
        roofline = {}
        if "tflops_per_s" in knn_m:
            roofline["knn_tflops_per_s"] = round(knn_m["tflops_per_s"], 2)
        if "mfu_pct" in knn_m:
            roofline["knn_mfu_pct"] = knn_m["mfu_pct"]
        if "hbm_gb_per_s" in embed_m:
            roofline["embed_hbm_gb_per_s"] = round(embed_m["hbm_gb_per_s"], 2)
        if "hbm_util_pct" in embed_m:
            roofline["embed_hbm_util_pct"] = embed_m["hbm_util_pct"]
        if roofline:
            print(f"[bench] roofline: {roofline}", file=sys.stderr)

    # CPU-oracle baseline on the IDENTICAL dataset (same reads, same N).
    # Earlier rounds extrapolated from a 300-read matched-coverage subset,
    # but the oracle's per-read cost is ~N^1.14 (measured: 232 reads/s at
    # n=300, 45 at n=1500, 41 at n=3000) — the subset flattered the CPU
    # ~6x and made vs_baseline meaningless across rounds. Full-N costs
    # ~3.5 min at the default 7500 reads; BENCH_BASELINE_READS caps the
    # subset size for quick runs (0/unset = full N, with a floor so the
    # cap can't resurrect the flattering tiny-subset regime).
    if baseline_reads and baseline_reads < n_reads:
        # capped path: matched-coverage smaller genome (a raw read subset
        # would have ~1/5 the coverage and an empty min-multiplicity
        # library), floored at 1500 reads to stay out of the flattering
        # tiny-subset regime
        cap = max(baseline_reads, 1500)
        base_sim = simulate_reads(
            genome_length=max(50_000, genome * cap // max(n_reads, 1)),
            coverage=coverage, mean_read_length=read_len,
            error_rate=0.05, seed=1234,
        )
        sub = base_sim.sequences
    else:
        sub = sim.sequences
    # best-of-2, symmetric with the device best-of-4 above
    otimes = []
    for _ in range(2):
        t0 = time.perf_counter()
        oracle.run_oracle_pipeline(
            sub, k=15, sample_fraction=0.05, min_multiplicity=2,
            n_components=512, n_neighbors=50, library_seed=602,
            projection_seed=2094,
        )
        otimes.append(time.perf_counter() - t0)
    oracle_s = min(otimes)
    oracle_rps = len(sub) / oracle_s
    print(f"[bench] oracle CPU: {oracle_s:.2f}s for {len(sub)} reads = "
          f"{oracle_rps:.1f} reads/s", file=sys.stderr)

    line = {
        "metric": "reads_per_s",
        "value": round(device_rps, 2),
        "unit": "reads/s",
        "vs_baseline": round(device_rps / oracle_rps, 2),
        "device_kind": dev.device_kind,
        "power_limit": power_limit(),
    }
    line.update(roofline)

    # Rung-scale second metric: the dmel-shaped rung (60k reads, 120k x 512
    # k-NN) through bench/run.py's run_one, in this process after the
    # primary cell. A rung failure fails the bench.
    if os.environ.get("BENCH_RUNG", "1") != "0":
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "bench", "run.py")
        spec = importlib.util.spec_from_file_location("bench_run", path)
        bench_run = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench_run)
        rung_row = bench_run.run_one(bench_run.CONFIGS["dmel"],
                                     compute_recall=False)
        line["rung"] = "dmel"
        line["rung_reads_per_s"] = rung_row["reads_per_s"]
        line["rung_knn_mfu_pct"] = (
            rung_row.get("roofline", {}).get("knn", {}).get("mfu_pct"))
        print(f"[bench] rung dmel: {rung_row['reads_per_s']} reads/s "
              f"(stages: {rung_row['stages_s']})", file=sys.stderr)

    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
