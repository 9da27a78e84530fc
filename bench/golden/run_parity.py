"""Replay the pinned golden artifacts through OUR pipeline and report
neighbor-recall@k vs the reference-code output (see make_golden.py)."""
import os, sys, tempfile
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.join(HERE, "..", ".."))
import numpy as np

def main(data=None, k_eval=20):
    data = data or os.path.join(HERE, "data")
    from fedrann_jax.cli import config_from_args
    from fedrann_jax.pipeline import run_pipeline
    from fedrann_jax.eval import OverlapTable, neighbor_recall
    out = tempfile.mkdtemp()
    config = config_from_args([
        "-i", os.path.join(data, "reads.fasta.gz"),
        "-o", out, "-k", "15",
        "--import-library", os.path.join(data, "fwd_kmer_library.fasta"),
        "--import-projection", os.path.join(data, "precompute.npz"),
        "--nndescent-n-neighbors", "20",
        "--seed", "20260817",
    ])
    run_pipeline(config)
    ref = OverlapTable.read(os.path.join(data, "overlaps_ref.tsv"))
    ours = OverlapTable.read(os.path.join(out, "overlaps.tsv"))
    rep = neighbor_recall(ref, ours, k=k_eval)
    print(rep)
    return rep

if __name__ == "__main__":
    rep = main()
    assert rep.recall_at_k >= 0.99, rep.recall_at_k
    print("GOLDEN PARITY OK")
