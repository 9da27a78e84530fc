"""Pipeline configuration.

Replaces the reference's argparse-plus-mutable-module-globals scheme
(reference fedrann/global_variables.py:1-7, fedrann/__main__.py:69-171) with a
single immutable dataclass threaded explicitly through the pipeline.

Defaults mirror the reference CLI defaults (fedrann/__main__.py:89-167):
k=16, sample_fraction=0.005, min_multiplicity=2, embedding_dimension=500,
n_neighbors=50, seed=356115, chunk_size=1000. The reference hard-codes the
projection seed to 2094 independently of --seed (fedrann/precompute.py:63);
we expose that as an explicit, documented knob `projection_seed`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # --- Reference-compatible knobs (fedrann/__main__.py:69-171) ---
    input_path: str = ""
    output_dir: str = ""
    kmer_size: int = 16                   # -k / --kmer-size
    kmer_sample_fraction: float = 0.005   # --kmer-sample-fraction
    kmer_min_multiplicity: int = 2        # --kmer-min-multiplicity
    threads: int = 1                      # --threads (host-side IO workers)
    # --chunk-size (reads per device batch). None = auto: window_batch
    # decides, keeping device program launches few. The reference's default
    # of 1000 sized process-pool tasks (__main__.py:120-125) — an
    # explicitly-passed value is still honored as a hard cap.
    chunk_size: Optional[int] = None
    embedding_dimension: int = 500        # -n / --embedding-dimension
    n_neighbors: int = 50                 # --nndescent-n-neighbors
    n_trees: int = 300                    # accepted for CLI parity; unused by
    #                                       exact search (reference __main__.py:132)
    seed: int = 356115                    # --seed
    save_feature_matrix: bool = False     # --save-feature-matrix (reference
    #                                       documents but never writes it:
    #                                       README.md:66; we implement it)
    keep_intermediates: bool = False      # --keep-intermediates
    mprof: bool = False                   # --mprof (stage memory metrics)

    # --- Knobs with no reference equivalent ---
    # Projection RNG seed; the reference silently fixes this to 2094
    # (precompute.py:63) regardless of --seed.
    projection_seed: int = 2094
    # SRP density; "auto" = 1/sqrt(n_features) (reference precompute.py:80-81).
    projection_density: Optional[float] = None
    # Cap on distinct library hits per read; reference sets are unbounded
    # (kmer_searcher.cpp:309). Hits beyond the cap are dropped and logged.
    # ceiling on staged candidate-hit occurrences per read (None = the
    # auto mean+6-sigma staging width is the only cap); a real knob —
    # overflow beyond it is counted and warned
    max_hits_per_read: int | None = None
    # Number of window positions processed per device batch in k-mer stages.
    # 32M windows = 2048 rows at the 16 kb bucket: big batches keep the
    # launch count low while intermediates stay comfortably in device
    # memory.
    window_batch: int = 1 << 25
    # Padded read-length buckets (bases). Reads are grouped into the smallest
    # bucket that fits; reads longer than the last bucket are chunk-split.
    # None (the default) derives a pow2 ladder from the input's own length
    # histogram (io.packing.auto_length_buckets) — every device stage does
    # work proportional to the padded length, so data-fit buckets cut the
    # staging sort and embed gather volume 1.5-4x vs the old fixed ladder.
    length_buckets: Optional[Sequence[int]] = None
    # Query-tile rows for the brute-force top-k. Selection+merge rounds
    # cost more than the matmul, so few, wide candidate blocks are the
    # default; not yet tuned on the GPU. Score temp is qt*ct*4 B = 268 MB.
    knn_query_tile: int = 512
    # Candidate-block columns per selection round (also the per-ring-step
    # block in the sharded top-k).
    knn_candidate_tile: int = 131072
    # Matmul precision for the distance matrix: "bf16" (bf16 operands on the
    # tensor cores, fp32 accumulation) or "fp32" (Precision.HIGHEST: true
    # fp32, never TF32 — knn/topk.scores_nt).
    knn_precision: str = "bf16"
    # Candidate movement across devices: "allgather" (small N), "ring"
    # (ppermute streaming over the 1-D data axis), or "ring2d" (ring-over-
    # ring on a ("hosts", "data") mesh — rotation inside each host, bulk
    # hops between hosts; knn/ring.py _ring2d_body).
    knn_shard_strategy: str = "ring"
    # Search algorithm: "exact" (brute-force all-vs-all, the default and
    # the recall gold standard) or "ivf" (sub-quadratic coarse-k-means
    # prefilter + exact cosine rescore — knn/ivf.py; the scaling valve for
    # rungs past chr1, analogous to the reference's pynndescent,
    # nearest_neighbors.py:39-55).
    knn_method: str = "exact"
    # IVF knobs: cluster count (None = auto ~2*sqrt(N) pow2) and probed
    # clusters per query (recall knob; more probes = higher recall,
    # linearly more distance work).
    knn_ivf_clusters: Optional[int] = None
    knn_ivf_probes: int = 8
    # Clusters each DB row is indexed in (overlapping clusters / spill,
    # after ScaNN-SOAR). Read embeddings lie on the genome's overlap
    # manifold; k-means boundaries cut true neighbor pairs and single
    # assignment plateaus near 0.8 recall at the rungs — spill=2 re-finds
    # boundary pairs from the other side for 2x rescore FLOPs.
    knn_ivf_spill: int = 2
    # "never" (default): one device, whatever the host holds; "auto": shard
    # the k-NN over all devices when more than one is visible; "always":
    # require a mesh. Sharding is opt-in, so a host with several cards runs
    # the same path as a host with one unless asked.
    knn_sharded: str = "never"
    # Out-of-core k-NN valve (knn/ooc.py, docs/SCALING.md): a device-memory
    # budget in BYTES. When the embedding matrix + k-NN working set (~6 bytes per
    # element: f32 matrix + bf16 search copy) would exceed it, the
    # embeddings are built HOST-resident (compute_embeddings out='host')
    # and searched out-of-core with streamed candidate blocks. None = off
    # (in-core device-resident path). The whole-human rung (BASELINE.json)
    # runs through this valve.
    knn_hbm_budget: Optional[int] = None
    # Distance wire format for the k-NN device->host copy: "u16" halves
    # the payload (~1.5e-5 max rounding error — knn/topk.py quantize_dist);
    # "f32" is the exact copy.
    knn_transfer: str = "u16"
    # Projection-table storage dtype: "bf16" (default — halves the embed
    # gather traffic and the resident table; accumulation stays f32) or
    # "f32" (exact storage).
    projection_dtype: str = "signs"
    # Write a jax.profiler trace (XPlane, viewable in TensorBoard /
    # xprof) to <output_dir>/trace. Replaces the reference's
    # memory-profiler-only story (SURVEY.md §5 tracing).
    profile: bool = False
    # Stage-boundary checkpoint directory (inside output_dir) or None.
    checkpoint: bool = False
    # Mesh shape for multi-device runs; None = all local devices on one axis.
    mesh_shape: Optional[Sequence[int]] = None
    # Cache the bucketed packed-read representation in the output dir and
    # reuse it when input identity (path+size+mtime) and buckets match —
    # reruns skip the host FASTX parse entirely (io/cache.py).
    pack_cache: bool = True
    # Golden-parity imports: use a reference run's sampled k-mer library
    # (jellyfish-dump FASTA, compat.load_reference_library) and/or its
    # precompute matrix (scipy .npz, compat.load_reference_precompute)
    # instead of building our own — isolates embedding-level parity from
    # sampling differences (SURVEY.md §7.3).
    import_library: Optional[str] = None
    import_projection: Optional[str] = None
    log_level: str = "INFO"
    # Multi-host launch (parallel/runtime.py): one process per host.
    # num_processes > 1 (or a coordinator address / JAX_COORDINATOR_ADDRESS)
    # routes the CLI through run_pipeline_multihost.
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    coordinator: Optional[str] = None

    @property
    def k(self) -> int:
        return self.kmer_size

    def __post_init__(self):
        if not (1 <= self.kmer_size <= 31):
            raise ValueError(f"kmer_size must be in [1, 31], got {self.kmer_size}")
        if not (0.0 < self.kmer_sample_fraction <= 1.0):
            raise ValueError("kmer_sample_fraction must be in (0, 1]")
        if self.embedding_dimension < 1:
            raise ValueError("embedding_dimension must be >= 1")
        if self.knn_precision not in ("bf16", "fp32"):
            raise ValueError("knn_precision must be 'bf16' or 'fp32'")
        if self.knn_shard_strategy not in ("allgather", "ring", "ring2d"):
            raise ValueError(
                "knn_shard_strategy must be 'allgather', 'ring', or 'ring2d'")
        if self.knn_sharded not in ("auto", "never", "always"):
            raise ValueError("knn_sharded must be 'auto', 'never', or 'always'")
        if self.knn_transfer not in ("u16", "f32"):
            raise ValueError("knn_transfer must be 'u16' or 'f32'")
        if self.projection_dtype not in ("signs", "bf16", "f32"):
            raise ValueError(
                "projection_dtype must be 'signs', 'bf16' or 'f32'")
        if self.knn_method not in ("exact", "ivf"):
            raise ValueError("knn_method must be 'exact' or 'ivf'")
        if self.knn_ivf_probes < 1:
            raise ValueError("knn_ivf_probes must be >= 1")
        if self.knn_ivf_spill < 1:
            raise ValueError("knn_ivf_spill must be >= 1")
        if self.knn_hbm_budget is not None and self.knn_hbm_budget < (1 << 20):
            raise ValueError(
                "knn_hbm_budget must be at least 1 MiB (plan_ooc floors "
                "the block and tile sizes; a budget below them is "
                "unsatisfiable, not just slow)")
