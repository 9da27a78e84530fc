"""overlaps.tsv writer.

Output contract from reference fedrann/__main__.py:261-300 and
README.md:68-90: six columns (query_name, query_orientation, target_name,
target_orientation, neighbor_rank, distance). Row r of the embedding matrix
maps to read r//2, orientation '+' if r%2==0 else '-' (reference
__main__.py:277-282). The self row (target_index == query_index) is skipped
but keeps its enumerate position, so real neighbors typically carry ranks
1..k-1 (reference __main__.py:278-288); the query's own reverse-complement
row is intentionally NOT filtered, matching the reference.
"""

from __future__ import annotations

from typing import IO, Sequence

import numpy as np

HEADER = (
    "query_name\tquery_orientation\ttarget_name\ttarget_orientation"
    "\tneighbor_rank\tdistance\n"
)


def _orientation(row: int) -> str:
    return "+" if row % 2 == 0 else "-"


def _filter_rows(indices: np.ndarray, distances: np.ndarray,
                 row_offset: int = 0):
    """Self-row / unset filter shared by both writers. row_offset maps
    local matrix row q to global embedding row row_offset+q."""
    n, k = indices.shape
    rows = np.arange(row_offset, row_offset + n)[:, None]
    keep = (indices != rows) & (indices >= 0)
    return (
        np.broadcast_to(rows, indices.shape)[keep],
        indices[keep],
        np.broadcast_to(np.arange(k)[None, :], indices.shape)[keep],
        distances[keep],
    )


def write_overlaps_tsv(
    out: IO[str],
    names: Sequence[str],
    neighbor_indices: np.ndarray,  # (rows, k) int
    neighbor_distances: np.ndarray,  # (rows, k) float
    row_offset: int = 0,
) -> int:
    """Write the overlap table; returns data rows written. Python loop —
    the behavioral oracle; write_overlaps_path uses the C fast path.
    row_offset: global embedding row of matrix row 0 (multi-host ranks
    write only their own query rows; names stay globally indexed)."""
    out.write(HEADER)
    q_rows, t_rows, ranks, dists = _filter_rows(
        np.asarray(neighbor_indices), np.asarray(neighbor_distances),
        row_offset,
    )
    for q, t, r, d in zip(q_rows, t_rows, ranks, dists):
        out.write(
            f"{names[q // 2]}\t{_orientation(q)}\t{names[t // 2]}"
            f"\t{_orientation(t)}\t{r}\t{float(d):.9g}\n"
        )
    return len(q_rows)


def write_overlaps_path(
    path: str,
    names: Sequence[str],
    neighbor_indices: np.ndarray,
    neighbor_distances: np.ndarray,
    row_offset: int = 0,
) -> int:
    """Write overlaps.tsv to a path; C writer when the native library is
    built (python writers cost seconds per million rows on throttled
    hosts), python fallback otherwise."""
    from fedrann_jax.io import native as native_io

    if native_io.native_available():
        with open(path, "w") as f:
            f.write(HEADER)
        return native_io.write_overlaps_matrix_native(
            path, list(names), np.asarray(neighbor_indices),
            np.asarray(neighbor_distances), row_offset,
        )
    with open(path, "w") as f:
        return write_overlaps_tsv(f, names, neighbor_indices,
                                  neighbor_distances, row_offset)
