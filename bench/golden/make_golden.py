"""Generate the pinned golden-parity artifact set by RUNNING THE REFERENCE.

VERDICT r1 missing item 1: every recall number so far was measured against
the in-repo oracle, never against reference-code output. This script runs
the reference's own code on a small simulated read set and pins the
artifacts that tests/test_golden_parity.py replays against our pipeline:

  reference side (all code under /root/reference):
    - kmer_searcher.cpp compiled as-is with a std-container shim for the
      un-vendored robin-hood submodule (shim/robin_hood.h) -> output.bin
    - fedrann.precompute.get_precompute_matrix (scipy, verbatim) -> P
    - fedrann.feature_extraction.get_feature_matrix + get_metadata
      (verbatim, numba/Bio/ahocorasick/sharedmem stubbed — only dead code
      uses them) -> reference embedding matrix
    - exact cosine top-k on those embeddings -> overlaps_ref.tsv with the
      reference's output semantics (self filter, enumerate ranks,
      __main__.py:261-300). pynndescent itself cannot run here (numba is
      not installed and installs are not possible); exact search is the
      recall-dominating stand-in SURVEY.md §2.7 argues for.

  shared inputs (level the library-sampling difference, SURVEY.md §7.3):
    - reads.fasta (simulated)
    - fwd_kmer_library.fasta in jellyfish-dump format, built by the oracle
      (awk's rand() stream is awk-implementation-defined, so ANY sampled
      library is "a valid run"; both sides consume THIS file)

Run:  python bench/golden/make_golden.py [outdir=bench/golden/data]
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
REF = "/root/reference"
sys.path.insert(0, REPO)

# --- reference-import stubs (unused-by-us dependencies absent here) --------
for name in ("ahocorasick", "sharedmem", "pysam"):
    sys.modules.setdefault(name, types.ModuleType(name))
import gzip as _gzip

isal = types.ModuleType("isal")
isal.igzip = _gzip  # same open() API; only used for .gz inputs (none here)
sys.modules.setdefault("isal", isal)
sys.modules.setdefault("isal.igzip", _gzip)
bio = types.ModuleType("Bio")
bio.SeqIO = types.ModuleType("Bio.SeqIO")
sys.modules.setdefault("Bio", bio)
numba = types.ModuleType("numba")
numba.njit = lambda *a, **k: (a[0] if a and callable(a[0]) else (lambda f: f))
sys.modules.setdefault("numba", numba)
sys.path.insert(0, REF)

# GOLDEN_K=21 exercises the reference's uint64 two-word-code path against
# our k>16 codec (generate into a separate outdir, e.g. data_k21)
K = int(os.environ.get("GOLDEN_K", "15"))
SAMPLE_FRACTION = float(os.environ.get("GOLDEN_SAMPLE", "0.15"))
MIN_MULT = 2
D = 256
N_NEIGHBORS = 20
SEED = 20260817

BASES = "ACGT"


def decode_kmer(code: int, k: int) -> str:
    out = []
    for i in range(k):
        out.append(BASES[(code >> (2 * (k - 1 - i))) & 3])
    return "".join(out)


def revcomp(s: str) -> str:
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def main() -> None:
    outdir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(HERE, "data")
    os.makedirs(outdir, exist_ok=True)
    tmp = os.path.join(outdir, "tmp")
    os.makedirs(tmp, exist_ok=True)

    import numpy as np

    from fedrann_jax import oracle
    from fedrann_jax.io.packing import encode_bases
    from fedrann_jax.sim import simulate_reads, write_fasta

    sim = simulate_reads(genome_length=120_000, coverage=8,
                         mean_read_length=3000, error_rate=0.03, seed=SEED)
    reads_fasta = os.path.join(outdir, "reads.fasta")
    write_fasta(reads_fasta, sim.names, sim.sequences)
    print(f"[golden] {len(sim.names)} reads", flush=True)

    # shared sampled library (jellyfish-dump format: '>count\nKMER')
    lib = oracle.build_library(sim.sequences, K, MIN_MULT, SAMPLE_FRACTION,
                               SEED)
    lib_fasta = os.path.join(outdir, "fwd_kmer_library.fasta")
    kmers = [decode_kmer(int(c), K) for c in lib.codes]
    with open(lib_fasta, "w") as f:
        for km, cnt in zip(kmers, lib.counts):
            f.write(f">{cnt}\n{km}\n")
    # sanity: decode inverts our coding
    assert int(oracle.kmer_code(encode_bases(kmers[0]), K)[0]) == int(lib.codes[0])
    kmer_count = len(kmers)
    n_features = 2 * kmer_count
    print(f"[golden] library: {kmer_count} k-mers", flush=True)

    # combined fwd+rev stream for the scanner (count_kmers.py:131-139:
    # seqkit seq -r -p then cat fwd rev | grep -v '^>')
    lib_stream = os.path.join(tmp, "lib_combined.txt")
    with open(lib_stream, "w") as f:
        for km in kmers:
            f.write(km + "\n")
        for km in kmers:
            f.write(revcomp(km) + "\n")

    # build + run the reference scanner
    ks_bin = os.path.join(tmp, "kmer_searcher")
    subprocess.run(
        ["g++", "-O3", "-std=c++17", "-I", os.path.join(HERE, "shim"),
         "-o", ks_bin, os.path.join(REF, "kmer_searcher/kmer_searcher.cpp"),
         "-lpthread"],
        check=True,
    )
    ks_out = os.path.join(tmp, "ks")
    os.makedirs(ks_out, exist_ok=True)
    subprocess.run(
        [ks_bin, lib_stream, reads_fasta, ks_out, str(K), "2"], check=True
    )
    output_bin = os.path.join(ks_out, "output.bin")
    shutil.copy(output_bin, os.path.join(outdir, "output.bin"))
    print("[golden] reference scan done", flush=True)

    # reference precompute (verbatim)
    from fedrann import global_variables
    global_variables.threads = 2
    global_variables.seed = SEED
    from fedrann.precompute import get_precompute_matrix
    import scipy.sparse as sp

    p, _nf = get_precompute_matrix(
        n_components=D, counter_file=lib_fasta, n_features=n_features,
        density="auto", seed=2094,
    )
    sp.save_npz(os.path.join(outdir, "precompute.npz"), sp.csr_matrix(p))
    print(f"[golden] reference precompute {p.shape}", flush=True)

    # reference feature matrix + metadata (verbatim; both call sites pass
    # kmer_count=n_features — reference __main__.py:339-345, :373-376 —
    # and parse mirrors with kmer_count/2)
    from fedrann.feature_extraction import get_feature_matrix, get_metadata

    read_count = len(sim.names)
    fm = get_feature_matrix(output_bin, p, n_features, read_count,
                            chunk_size=64)
    names, strands = get_metadata(output_bin, n_features)  # per-ROW lists
    print(f"[golden] reference embeddings {fm.shape}", flush=True)

    # exact cosine top-k + reference output semantics (__main__.py:261-300)
    idx, dist = oracle.knn_cosine(fm, N_NEIGHBORS)
    ref_tsv = os.path.join(outdir, "overlaps_ref.tsv")
    with open(ref_tsv, "w") as f:
        f.write("query_name\tquery_orientation\ttarget_name\t"
                "target_orientation\tneighbor_rank\tdistance\n")
        for qi in range(idx.shape[0]):
            qname = names[qi]
            qori = "+" if strands[qi] == 0 else "-"
            for rank, (ti, dd) in enumerate(zip(idx[qi], dist[qi])):
                if int(ti) == qi:
                    continue  # self row filter (reference __main__.py:279)
                tname = names[int(ti)]
                tori = "+" if strands[int(ti)] == 0 else "-"
                f.write(f"{qname}\t{qori}\t{tname}\t{tori}\t{rank}\t{dd}\n")
    np.save(os.path.join(outdir, "ref_embeddings.npy"), fm)
    with open(os.path.join(outdir, "ref_row_names.txt"), "w") as f:
        for n in names:
            f.write(n + "\n")
    shutil.rmtree(tmp)
    # gzip the reads (what the parity test feeds the CLI) + record config
    import gzip as gz
    import json
    with open(reads_fasta, "rb") as fin, \
            gz.open(reads_fasta + ".gz", "wb") as fout:
        fout.write(fin.read())
    os.remove(reads_fasta)
    with open(os.path.join(outdir, "meta.json"), "w") as f:
        json.dump({"k": K, "sample_fraction": SAMPLE_FRACTION,
                   "n_neighbors": N_NEIGHBORS, "seed": SEED, "dim": D}, f)
    print(f"[golden] wrote artifacts to {outdir}", flush=True)


if __name__ == "__main__":
    main()
