"""Named benchmark configurations mirroring BASELINE.json's ladder.

Real datasets (E. coli ONT, D. melanogaster HiFi, human chr1) are not
available in this environment, so each rung is a simulated stand-in with
the same workload *shape*: genome scale, coverage, read length, k, and
sample fraction. The CPU-oracle baseline is run at matched coverage.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BenchConfig:
    name: str
    genome: int
    coverage: float
    read_len: int
    k: int
    sample_fraction: float
    min_multiplicity: int = 2
    dim: int = 512
    n_neighbors: int = 50
    error_rate: float = 0.05
    # None = the pipeline's auto pow2 ladder (io.packing.auto_length_buckets)
    length_bucket: int | None = None
    # extra CLI flags appended verbatim (e.g. the human rung's forced
    # --knn-hbm-budget that trips the out-of-core valve, docs/SCALING.md)
    extra_args: tuple = ()
    # BASELINE.json rung this models
    models: str = ""

    def length_buckets_arg(self) -> str:
        return "auto" if self.length_bucket is None else str(self.length_bucket)


CONFIGS = {
    "ci": BenchConfig(
        name="ci", genome=2_000_000, coverage=12, read_len=8000, k=15,
        sample_fraction=0.05,
        models="test/data/reads.fasta.gz CI workload (k=15, 5% sample)",
    ),
    "ecoli": BenchConfig(
        name="ecoli", genome=4_600_000, coverage=50, read_len=8000, k=15,
        sample_fraction=0.05,
        models="E. coli ONT ~50x, single chip, full brute-force k-NN",
    ),
    "dmel": BenchConfig(
        name="dmel", genome=30_000_000, coverage=30, read_len=15000, k=21,
        sample_fraction=0.005, error_rate=0.01,
        models="D. melanogaster HiFi ~30x, k=21 (two-word code path)",
    ),
    "chr1": BenchConfig(
        name="chr1", genome=120_000_000, coverage=30, read_len=10000, k=15,
        sample_fraction=0.005,
        models="Human chr1 ONT ~30x (multi-host data-parallel rung)",
    ),
    # The pod-scale streaming rung, scaled to what this host can simulate:
    # 720k reads x d=512 -> a 4.4 GB k-NN working set, forced past a 2 GB
    # HBM budget so the run exercises the FULL out-of-core path (host-mode
    # embed, chunked normalize, slab/block streaming search) at an honest
    # scale. docs/SCALING.md derives the same model at the real 2e7-read
    # whole-human shape.
    "human": BenchConfig(
        name="human", genome=240_000_000, coverage=30, read_len=10000, k=15,
        sample_fraction=0.005,
        extra_args=("--knn-hbm-budget", "2G"),
        models="Whole-human ONT ~30x pod-scale streaming rung "
               "(out-of-core k-NN past a forced 2 GB HBM budget)",
    ),
}
