"""FEDRANN-JAX: a JAX read-overlap detection engine.

Reimplements the capabilities of the FEDRANN pipeline (reference:
v0.5.4 — Feature Extraction, Dimensionality Reduction, Approximate Nearest
Neighbor search for long-read overlap candidates) as one JAX/XLA program:

- k-mer counting/sampling/membership on-device (replaces jellyfish + awk +
  seqkit + the C++ kmer_searcher; reference fedrann/count_kmers.py,
  kmer_searcher/kmer_searcher.cpp),
- sparse-random-projection x ICF embedding as device matmuls (reference
  fedrann/precompute.py, fedrann/feature_extraction.py),
- exact tiled brute-force cosine top-k with sharded/ring variants over a
  jax.sharding.Mesh (replaces pynndescent; reference
  fedrann/nearest_neighbors.py),
- the same CLI surface and overlaps.tsv output contract (reference
  fedrann/__main__.py).
"""

import os as _os

# Keep large numpy/XLA host buffers on glibc's reusable brk heap: by default
# every free above 128 KB (the mmap threshold) goes back to the OS, and the
# next allocation of that size faults its pages in again. Whether this still
# pays on current hosts is unmeasured.
try:
    import ctypes as _ctypes

    _libc = _ctypes.CDLL("libc.so.6", use_errno=True)
    _libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
    _libc.mallopt(-4, 0)        # M_MMAP_MAX: never mmap, always reuse heap
except OSError:  # non-glibc platforms: skip
    pass

import jax as _jax

# k-mer codes for k <= 31 need up to 62 bits; enable 64-bit types once,
# package-wide. All float compute paths request explicit float32/bfloat16.
_jax.config.update("jax_enable_x64", True)

# Persistent compilation cache. JAX itself reads JAX_COMPILATION_CACHE_DIR;
# when it is unset the cache sits at a fixed path in the checkout (the path
# is part of the cache key, so a directory that moves never hits).
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"
__description__ = (
    "Long-read overlap detection via k-mer features, "
    "random-projection embeddings, and exact cosine k-NN."
)
