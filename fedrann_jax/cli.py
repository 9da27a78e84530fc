"""Command-line interface.

Flag-for-flag parity with the reference CLI (reference __main__.py:69-171):
-i/--input, -o/--output-dir, -k/--kmer-size, --kmer-sample-fraction,
--kmer-min-multiplicity, --threads, --chunk-size, -n/--embedding-dimension,
--nndescent-n-trees, --nndescent-n-neighbors, --seed, --save-feature-matrix,
--keep-intermediates, --mprof — plus knobs of its own. --nndescent-n-trees
is accepted and ignored (exact search has no trees); --projection-seed
surfaces the reference's hidden hard-coded SRP seed 2094
(precompute.py:63) as a real flag.
"""

from __future__ import annotations

import argparse
import sys

from fedrann_jax import __description__, __version__
from fedrann_jax.config import PipelineConfig
from fedrann_jax.logging_utils import logger


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fedrann-jax",
        description=__description__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("-i", "--input", required=True,
                   help="Path to the input FASTQ/FASTA file (optionally .gz).")
    p.add_argument("-o", "--output-dir", required=True,
                   help="Directory to save output files.")
    p.add_argument("-k", "--kmer-size", type=int, default=16,
                   help="K-mer size for feature extraction.")
    p.add_argument("--kmer-sample-fraction", type=float, default=0.005,
                   help="Fraction of k-mers used to build the feature matrix.")
    p.add_argument("--kmer-min-multiplicity", type=int, default=2,
                   help="Minimum allowed frequency of a k-mer in all reads.")
    p.add_argument("--threads", type=int, default=1,
                   help="Host-side worker threads (I/O).")
    p.add_argument("--chunk-size", type=int, default=None,
                   help="Reads per device batch (default: auto-sized).")
    p.add_argument("-n", "--embedding-dimension", type=int, default=500)
    p.add_argument("--nndescent-n-trees", type=int, default=300,
                   help="Accepted for reference-CLI parity; unused (search is exact).")
    p.add_argument("--nndescent-n-neighbors", type=int, default=50,
                   help="Number of neighbors per query row. The reference "
                        "default 50 measurably under-recalls true overlaps "
                        "on noisy ONT-shaped data (0.768 @50 vs 0.892 @100 "
                        "on an E. coli ONT-like 50x set); use 100 for ONT "
                        "assemblies (README 'Choosing n-neighbors').")
    p.add_argument("--seed", type=int, default=356115,
                   help="Random seed (library sampling).")
    p.add_argument("--save-feature-matrix", action="store_true",
                   help="Save embeddings to feature_matrix.npz.")
    p.add_argument("--keep-intermediates", action="store_true",
                   help="Keep stage checkpoints (library, embeddings).")
    p.add_argument("--mprof", action="store_true",
                   help="Record memory usage to mprof.dat (mprof format).")
    # --- extensions with no reference equivalent ---
    p.add_argument("--projection-seed", type=int, default=2094,
                   help="SRP seed (the reference hard-codes 2094 regardless "
                        "of --seed; exposed here).")
    p.add_argument("--projection-density", type=float, default=None,
                   help="SRP density; default 1/sqrt(n_features).")
    p.add_argument("--max-hits-per-read", type=int, default=None,
                   help="Ceiling on staged candidate hits per read "
                        "(default: auto staging width); overflow is "
                        "counted and warned.")
    p.add_argument("--knn-precision", choices=("bf16", "fp32"), default="bf16",
                   help="Distance-matmul precision (fp32 accumulation either way).")
    # tile defaults live on PipelineConfig (512 / 131072, the measured-best
    # pair — config.py:66-74); None here means "use those" so the CLI can
    # never silently shadow them with stale copies
    p.add_argument("--knn-query-tile", type=int, default=None,
                   help="Query rows per top-k tile (default: config's 512).")
    p.add_argument("--knn-candidate-tile", type=int, default=None,
                   help="Candidate columns per selection round "
                        "(default: config's 131072).")
    p.add_argument("--knn-shard-strategy", choices=("allgather", "ring", "ring2d"),
                   default="ring", help="Candidate movement across chips.")
    p.add_argument("--knn-method", choices=("exact", "ivf"), default="exact",
                   help="Search algorithm: exact all-vs-all (default) or "
                        "ivf (sub-quadratic coarse-k-means prefilter + "
                        "exact rescore — the scaling valve past chr1).")
    p.add_argument("--knn-ivf-clusters", type=int, default=None,
                   help="IVF cluster count (default: auto ~2*sqrt(N)).")
    p.add_argument("--knn-ivf-probes", type=int, default=8,
                   help="IVF probed clusters per query (recall knob).")
    p.add_argument("--knn-ivf-spill", type=int, default=2,
                   help="Clusters each row is indexed in (overlapping "
                        "clusters; 2 recovers k-means boundary pairs on "
                        "read-overlap manifolds for 2x rescore FLOPs).")
    p.add_argument("--projection-dtype", choices=("signs", "bf16", "f32"),
                   default="signs",
                   help="Projection-table storage: 'signs' (default) packs "
                        "the ternary SRP signs 2 bits each + one f32 "
                        "magnitude per row — 8x smaller than bf16 and "
                        "reconstructs the f32 entries exactly; 'bf16'/'f32' "
                        "store the dense paired table (accumulation is "
                        "always f32).")
    p.add_argument("--knn-hbm-budget", type=str, default=None,
                   help="Device-memory budget for the k-NN working set, "
                        "e.g. '8G', '512M', or bytes. Embedding matrices past it are "
                        "built host-resident and searched out-of-core with "
                        "streamed candidate blocks (the whole-human "
                        "valve; docs/SCALING.md). Default: off.")
    p.add_argument("--knn-transfer", choices=("u16", "f32"), default="u16",
                   help="Distance wire format for the device->host copy "
                        "(u16 halves the payload; ~3e-5 max rounding).")
    p.add_argument("--knn-sharded", choices=("auto", "never", "always"),
                   default="never",
                   help="Shard the k-NN over the device mesh: never (one "
                        "device), auto (when more than one device is "
                        "visible) or always.")
    p.add_argument("--mesh-shape", type=str, default=None,
                   help="Comma-separated device-mesh shape, e.g. '2,4' = "
                        "(hosts, data) for ring2d (default: all local "
                        "devices on one axis).")
    p.add_argument("--window-batch", type=int, default=None,
                   help="Window positions per device batch in the k-mer "
                        "stages (default: config's 32M).")
    p.add_argument("--length-buckets", type=str, default="auto",
                   help="Comma-separated padded read-length buckets, or "
                        "'auto' (default) to derive a pow2 ladder from the "
                        "input's length histogram.")
    p.add_argument("--import-library", type=str, default=None,
                   help="Use a reference-run k-mer library (jellyfish-dump "
                        "FASTA) instead of building one (golden parity).")
    p.add_argument("--import-projection", type=str, default=None,
                   help="Use a reference-run precompute matrix (scipy .npz) "
                        "instead of generating the SRP (golden parity).")
    p.add_argument("--no-pack-cache", action="store_true",
                   help="Disable the packed-reads cache (fxcache.npz) that "
                        "lets reruns skip the host FASTX parse.")
    p.add_argument("--profile", action="store_true",
                   help="Write a jax.profiler trace to <output-dir>/trace.")
    p.add_argument("--log-level", default="INFO")
    # multi-host launch (one process per host; see parallel/runtime.py)
    p.add_argument("--num-processes", type=int, default=None,
                   help="Total processes in a multi-host launch.")
    p.add_argument("--process-id", type=int, default=None,
                   help="This process's rank in a multi-host launch.")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (JAX_COORDINATOR_ADDRESS).")
    return p


def parse_bytes(s: str | None) -> int | None:
    """'8G' / '512M' / '64K' / plain bytes -> int bytes (binary units)."""
    if s is None:
        return None
    s = s.strip().upper().removesuffix("B")
    units = {"K": 1 << 10, "M": 1 << 20, "G": 1 << 30, "T": 1 << 40}
    if s and s[-1] in units:
        return int(float(s[:-1]) * units[s[-1]])
    return int(s)


def config_from_args(argv: list[str] | None = None) -> PipelineConfig:
    args = build_parser().parse_args(argv)
    import dataclasses as _dc

    _defaults = {f.name: f.default for f in _dc.fields(PipelineConfig)}
    mesh_shape = (tuple(int(x) for x in args.mesh_shape.split(","))
                  if args.mesh_shape else None)
    return PipelineConfig(
        input_path=args.input,
        output_dir=args.output_dir,
        kmer_size=args.kmer_size,
        kmer_sample_fraction=args.kmer_sample_fraction,
        kmer_min_multiplicity=args.kmer_min_multiplicity,
        threads=args.threads,
        chunk_size=args.chunk_size,
        embedding_dimension=args.embedding_dimension,
        n_neighbors=args.nndescent_n_neighbors,
        n_trees=args.nndescent_n_trees,
        seed=args.seed,
        save_feature_matrix=args.save_feature_matrix,
        keep_intermediates=args.keep_intermediates,
        checkpoint=args.keep_intermediates,
        mprof=args.mprof,
        projection_seed=args.projection_seed,
        projection_density=args.projection_density,
        max_hits_per_read=args.max_hits_per_read,
        knn_precision=args.knn_precision,
        knn_query_tile=(args.knn_query_tile
                        if args.knn_query_tile is not None
                        else _defaults["knn_query_tile"]),
        knn_candidate_tile=(args.knn_candidate_tile
                            if args.knn_candidate_tile is not None
                            else _defaults["knn_candidate_tile"]),
        knn_sharded=args.knn_sharded,
        mesh_shape=mesh_shape,
        window_batch=(args.window_batch
                      if args.window_batch is not None
                      else _defaults["window_batch"]),
        knn_shard_strategy=args.knn_shard_strategy,
        knn_method=args.knn_method,
        knn_ivf_clusters=args.knn_ivf_clusters,
        knn_ivf_probes=args.knn_ivf_probes,
        knn_ivf_spill=args.knn_ivf_spill,
        knn_transfer=args.knn_transfer,
        knn_hbm_budget=parse_bytes(args.knn_hbm_budget),
        projection_dtype=args.projection_dtype,
        length_buckets=(None if args.length_buckets == "auto"
                        else tuple(int(x)
                                   for x in args.length_buckets.split(","))),
        import_library=args.import_library,
        import_projection=args.import_projection,
        pack_cache=not args.no_pack_cache,
        profile=args.profile,
        log_level=args.log_level,
        num_processes=args.num_processes,
        process_id=args.process_id,
        coordinator=args.coordinator,
    )


def main(argv: list[str] | None = None) -> int:
    config = config_from_args(argv)
    import os

    multi = (
        (config.num_processes or 0) > 1
        or config.coordinator
        or os.environ.get("JAX_COORDINATOR_ADDRESS")
    )
    if multi:
        from fedrann_jax.parallel.runtime import run_pipeline_multihost

        out = run_pipeline_multihost(config)
        if isinstance(out, tuple):
            library, _emb, _idx, _dist, out_path = out
            logger.info("done (multihost rank): %d library k-mers, output %s",
                        library.size, out_path)
            return 0
        result = out  # single-process degradation
    else:
        from fedrann_jax.pipeline import run_pipeline  # defer jax-heavy import

        result = run_pipeline(config)
    logger.info("done: %d reads, %d library k-mers, output %s",
                len(result.names), result.library.size, result.overlaps_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
