"""Benchmark ladder runner: python bench/run.py [name ...].

Runs each named config (bench/configs.py) through the device pipeline and
prints one JSON row per config: reads/s, stage breakdown and ground-truth
recall. The root bench.py prints the single-line throughput metric; this
runner is for the full ladder.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

# repo root for fedrann_jax; bench/ itself for configs (the root bench.py
# module shadows the bench/ directory as an import name)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from configs import CONFIGS  # noqa: E402

# Largest rung that still gets ground-truth recall. The sweep in
# sim.truth_overlaps is O(N x overlaps-per-read), not O(N^2): chr1's 360k
# reads (~8M truth pairs) take a few minutes of host time, paid AFTER the
# timed pipeline run so it never contends with the measurement.
RECALL_MAX_READS = 400_000


def run_one(cfg, warm: bool = True, compute_recall: bool = True) -> dict:
    from fedrann_jax.cli import config_from_args
    from fedrann_jax.eval import truth_recall
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.sim import simulate_reads, write_fasta

    def _sim():
        return simulate_reads(
            genome_length=cfg.genome, coverage=cfg.coverage,
            mean_read_length=cfg.read_len, error_rate=cfg.error_rate,
            seed=1234,
        )

    # persistent per-config workdir: reruns reuse the fasta and the packed
    # cache (a chr1-scale sim + write + parse costs over an hour). The
    # simulation itself is lazy: a retry with the fasta already on disk
    # skips it unless the rung is small enough to compute truth recall
    # (simulate_reads is seed-deterministic, so re-deriving it for truth
    # matches the cached fasta).
    if True:
        # FEDRANN_BENCH_WORK overrides the untracked bench/_work root
        work_root = os.environ.get("FEDRANN_BENCH_WORK") or os.path.join(
            os.path.dirname(os.path.abspath(__file__)), "_work")
        tmp = os.path.join(work_root, cfg.name.split(":")[0])
        os.makedirs(tmp, exist_ok=True)
        fasta = os.path.join(tmp, "reads.fasta")
        meta_path = fasta + ".meta.json"
        sim = None
        if os.path.exists(fasta) and os.path.exists(meta_path):
            with open(meta_path) as f:
                n_reads = json.load(f)["n_reads"]
        else:
            sim = _sim()
            n_reads = len(sim.names)
            write_fasta(fasta, sim.names, sim.sequences)
            with open(meta_path, "w") as f:
                json.dump({"n_reads": n_reads}, f)
        args = [
            "-i", fasta, "-o", os.path.join(tmp, "out"),
            "-k", str(cfg.k),
            "--kmer-sample-fraction", str(cfg.sample_fraction),
            "--kmer-min-multiplicity", str(cfg.min_multiplicity),
            "-n", str(cfg.dim),
            "--nndescent-n-neighbors", str(cfg.n_neighbors),
            "--seed", "602", "--length-buckets", cfg.length_buckets_arg(),
            "--threads", "4",
            *cfg.extra_args,
        ]
        # ad-hoc experiment flags (A/B runs) without editing configs.py;
        # recorded in the result row so experimental rows are labeled
        extra_env = os.environ.get("FEDRANN_BENCH_EXTRA_ARGS", "").split()
        args += extra_env
        config = config_from_args(args)
        if warm:
            run_pipeline(config)
        t0 = time.perf_counter()
        result = run_pipeline(config)
        wall = time.perf_counter() - t0

    if compute_recall and n_reads <= RECALL_MAX_READS and sim is None:
        # deterministic re-derivation (seed-fixed) for ground truth; done
        # after the timed run so sim CPU never contends with the pipeline
        sim = _sim()
    truth = (sim.truth_overlaps(min_overlap=max(500, cfg.read_len // 4))
             if compute_recall and sim is not None
             and n_reads <= RECALL_MAX_READS
             else None)
    recall = (
        truth_recall(result.neighbor_indices, truth, n_reads)
        if truth else float("nan")
    )
    # stratified: recall over pairs with >= half / >= three-quarter read
    # overlap (short-overlap pairs share few sampled k-mers and rank low —
    # a data property, not a search error; the curve documents it)
    strat = {}
    for frac_ov in (0.5, 0.75) if truth is not None else ():
        t2 = sim.truth_overlaps(min_overlap=int(cfg.read_len * frac_ov))
        if t2:
            strat[f"recall_ov{int(frac_ov*100)}"] = round(
                truth_recall(result.neighbor_indices, t2, n_reads), 4)
    return {
        **strat,
        **({"extra_args": " ".join(extra_env)} if extra_env else {}),
        "config": cfg.name,
        "warm": warm,
        "n_reads": n_reads,
        "reads_per_s": round(n_reads / wall, 2),
        "wall_s": round(wall, 2),
        "stages_s": {k: round(v["seconds"], 2)
                     for k, v in result.metrics.items()},
        "roofline": {k: {m: v[m] for m in
                         ("mfu_pct", "hbm_util_pct", "tflops_per_s")
                         if m in v}
                     for k, v in result.metrics.items()
                     if any(m in v for m in
                            ("mfu_pct", "hbm_util_pct", "tflops_per_s"))},
        "library_size": result.library.size,
        "truth_recall": round(recall, 4),
        "models": cfg.models,
    }


def main(argv):
    # "name:k=N" overrides n_neighbors for recall-vs-k curves
    names = argv or ["ci"]
    import dataclasses as _dc

    warm = True
    if "--cold" in names:
        # huge rungs: one measured run, compiles included (documented in
        # the row); a warmup doubles multi-hour walls for no information
        names = [n for n in names if n != "--cold"]
        warm = False
    compute_recall = True
    if "--no-recall" in names:
        # bench.py's rung subprocess: skip the minutes of host-side truth
        # derivation — it wants the throughput row only
        names = [n for n in names if n != "--no-recall"]
        compute_recall = False
    for name in names:
        if ":k=" in name:
            name, kk = name.split(":k=")
            cfg = _dc.replace(CONFIGS[name], n_neighbors=int(kk),
                              name=f"{name}:k={kk}")
        else:
            cfg = CONFIGS[name]
        print(f"=== {name}: {cfg.models}", file=sys.stderr)
        row = run_one(cfg, warm=warm, compute_recall=compute_recall)
        row["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
