"""Device mesh + sharding helpers.

The reference has no accelerator or multi-node parallelism of any kind
(SURVEY.md §2.8); this module defines the device analogues called for there:
read rows (both orientations) are **data-parallel** over the mesh's "data"
axis, the SRP/ICF precompute matrix is **replicated** (seed-deterministic
generation makes replication free), and the k-NN candidate shards move via
collectives (all_gather or ppermute ring — knn/ring.py).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
HOST_AXIS = "hosts"


def shard_map_norep(f, *, mesh, in_specs, out_specs):
    """shard_map with replication checking off, across the jax 0.7/0.8 API
    rename (check_rep -> check_vma) and the move out of experimental."""
    try:
        from jax import shard_map as _sm
    except ImportError:  # pragma: no cover
        from jax.experimental.shard_map import shard_map as _sm
    try:
        return _sm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_vma=False)
    except TypeError:  # pragma: no cover
        return _sm(f, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                   check_rep=False)


def make_mesh(shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D "data" mesh over all (or the given) devices. A 2-D
    ("hosts", "data") mesh is the multi-host extension once the links
    between hosts matter; every current collective rides the one axis."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is not None:
        n = int(np.prod(shape))
        devices = devices[:n]
    return Mesh(np.array(devices), (DATA_AXIS,))


def make_mesh_2d(n_hosts: int,
                 devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """2-D ("hosts", "data") mesh: the outer axis crosses host
    boundaries, the inner axis stays on one host's device links (SURVEY.md
    §2.8/§5 mesh-axes checklist). jax.devices() is process-major, so
    reshaping it (n_hosts, -1) puts each row of the mesh on one host:
    collectives over DATA_AXIS stay inside a host; collectives over
    HOST_AXIS are the bulk inter-host hops (knn/ring.py _ring2d_body)."""
    devices = list(devices if devices is not None else jax.devices())
    if len(devices) % n_hosts:
        raise ValueError(
            f"{len(devices)} devices do not split over {n_hosts} hosts"
        )
    return Mesh(np.array(devices).reshape(n_hosts, -1),
                (HOST_AXIS, DATA_AXIS))


def shard_rows(arr: jax.Array, mesh: Mesh) -> jax.Array:
    """Place a (N, ...) array row-sharded over the data axis."""
    spec = P(DATA_AXIS, *([None] * (arr.ndim - 1)))
    return jax.device_put(arr, NamedSharding(mesh, spec))


def replicate(arr: jax.Array, mesh: Mesh) -> jax.Array:
    return jax.device_put(arr, NamedSharding(mesh, P()))


def pad_rows_to_multiple(arr: np.ndarray, multiple: int) -> tuple[np.ndarray, int]:
    """Zero-pad rows so the leading dim divides the mesh size; returns
    (padded, original_rows)."""
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad:
        arr = np.concatenate(
            [arr, np.zeros((pad, *arr.shape[1:]), dtype=arr.dtype)], axis=0
        )
    return arr, n
