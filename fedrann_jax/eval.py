"""Evaluation: neighbor-recall@k between overlap tables.

The parity metric (BASELINE.json): for each query row of the reference
output, the fraction of its top-k neighbors that the candidate output also
reports for that row, plus distance agreement within a tolerance. Works on
overlaps.tsv files (reference format, README.md:68-90) or in-memory
neighbor arrays.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Mapping, Optional

import numpy as np


@dataclasses.dataclass
class OverlapTable:
    """Parsed overlaps.tsv: (query name, orientation) -> ordered neighbors."""

    neighbors: Mapping[tuple[str, str], list[tuple[str, str, int, float]]]

    @classmethod
    def read(cls, path: str) -> "OverlapTable":
        table: dict = collections.defaultdict(list)
        with open(path) as f:
            header = f.readline().rstrip("\n").split("\t")
            expected = ["query_name", "query_orientation", "target_name",
                        "target_orientation", "neighbor_rank", "distance"]
            if header != expected:
                raise ValueError(f"unexpected overlaps header: {header}")
            for line in f:
                q, qo, t, to, rank, dist = line.rstrip("\n").split("\t")
                table[(q, qo)].append((t, to, int(rank), float(dist)))
        return cls(neighbors=dict(table))


@dataclasses.dataclass
class RecallReport:
    recall_at_k: float          # mean per-query neighbor overlap fraction
    query_coverage: float       # fraction of reference queries present
    distance_mae: float         # mean |dist diff| over shared (q, t) pairs
    n_queries: int
    n_shared_pairs: int

    def __str__(self) -> str:
        return (f"recall@k={self.recall_at_k:.4f} "
                f"coverage={self.query_coverage:.4f} "
                f"distance_mae={self.distance_mae:.5f} "
                f"({self.n_queries} queries, {self.n_shared_pairs} shared pairs)")


def neighbor_recall(
    reference: OverlapTable,
    candidate: OverlapTable,
    k: Optional[int] = None,
    match_orientation: bool = True,
) -> RecallReport:
    """Per-query overlap of candidate vs reference neighbor sets.

    With match_orientation=False a neighbor counts as recovered if the
    candidate reports the read in either orientation (useful when comparing
    against tools with different strand conventions).
    """
    recalls = []
    dist_diffs = []
    n_shared = 0
    present = 0
    for key, ref_neigh in reference.neighbors.items():
        cand_neigh = candidate.neighbors.get(key)
        if cand_neigh is None:
            recalls.append(0.0)
            continue
        present += 1
        ref_k = ref_neigh[:k] if k else ref_neigh

        def ident(t, to):
            return (t, to) if match_orientation else t

        cand_map = {}
        for t, to, _rank, dist in cand_neigh:
            cand_map.setdefault(ident(t, to), dist)
        hit = 0
        for t, to, _rank, dist in ref_k:
            cd = cand_map.get(ident(t, to))
            if cd is not None:
                hit += 1
                dist_diffs.append(abs(cd - dist))
                n_shared += 1
        recalls.append(hit / max(1, len(ref_k)))
    return RecallReport(
        recall_at_k=float(np.mean(recalls)) if recalls else 0.0,
        query_coverage=present / max(1, len(reference.neighbors)),
        distance_mae=float(np.mean(dist_diffs)) if dist_diffs else 0.0,
        n_queries=len(reference.neighbors),
        n_shared_pairs=n_shared,
    )


def truth_recall(result_indices: np.ndarray, truth_pairs, n_reads: int) -> float:
    """Fraction of ground-truth overlapping read pairs (from the simulator)
    where either read lists the other among its neighbors (any orientation).
    result_indices: (2R, k) global embedding-row indices."""
    neigh = [set() for _ in range(n_reads)]
    for row in range(result_indices.shape[0]):
        q = row // 2
        for t in result_indices[row]:
            neigh[q].add(int(t) // 2)
    found = sum(1 for a, b in truth_pairs if b in neigh[a] or a in neigh[b])
    return found / max(1, len(truth_pairs))


def main(argv=None) -> int:
    """CLI: compare two overlaps.tsv tables.

    python -m fedrann_jax.eval reference.tsv ours.tsv [-k K]
    Prints the recall@k / coverage / distance-MAE line and exits 0 when
    both tables parsed (the caller judges thresholds). The reference has
    no such tool; parity runs against it needed one (SURVEY.md §4 golden
    comparison)."""
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="fedrann-jax-eval",
        description="Neighbor-recall@k between two overlaps.tsv tables",
    )
    p.add_argument("reference", help="baseline overlaps.tsv")
    p.add_argument("candidate", help="overlaps.tsv to score")
    p.add_argument("-k", type=int, default=None,
                   help="truncate neighbor lists to k (default: full)")
    args = p.parse_args(argv)
    ref = OverlapTable.read(args.reference)
    got = OverlapTable.read(args.candidate)
    print(neighbor_recall(ref, got, k=args.k), file=sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
