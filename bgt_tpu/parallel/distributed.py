"""Multi-host execution: the sample-column mesh spanning several hosts.

Each host runs the same query process; JAX's distributed runtime stitches
the per-host devices into one global mesh and `shard_map` collectives run
over the links between the devices (NVLink within a host, the network
across hosts).  The data layout
follows the single-host design (docs/DESIGN.md §5):

- every host imports (or loads) the column slice of the tile store covering
  its own samples — the device-mesh generalization of the reference's "one BGT
  database per sub-cohort" composition;
- host-side site selection (CSI regions, BED, FMF metadata, paging) is
  replicated: each host computes the identical site stream, exactly like
  each bgt_t of a bgtm set advances in lockstep (reference bgt.c:803-820);
- per-site/per-group counts psum over the global sample axis; genotype
  output all-gathers only for sites that pass all filters.

Usage on each host (the coordinator address, process count and this
process's id are always given: nothing detects a cluster on its own):

    from bgt_tpu.parallel import distributed
    distributed.initialize("host0:12345", num_processes=2, process_id=0)
    mesh = distributed.global_mesh()  # ('s',) over every device of every host

then hand ``mesh`` to :func:`bgt_tpu.parallel.mesh.sharded_count_range_fn`
with each host's local plane shards placed via
``jax.make_array_from_single_device_arrays``.
"""

from __future__ import annotations

import jax
import numpy as np

from . import mesh as meshlib


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize; without a coordinator address (tests,
    one host) the process runs alone."""
    if jax.process_count() > 1:
        return  # already initialized
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        # single-process runs (tests, one host) proceed without the service
        pass


def global_mesh(axis: str = meshlib.SAMPLE_AXIS) -> jax.sharding.Mesh:
    """One-axis mesh over every device of every participating process."""
    return jax.sharding.Mesh(np.asarray(jax.devices()), (axis,))


def local_column_range(n_words: int, mesh: jax.sharding.Mesh) -> tuple[int, int]:
    """The [start, stop) word-column range this process's devices own.

    Ownership is by POSITION in the mesh's device order, not by raw device
    id: multi-process backends assign non-contiguous global ids (e.g. CPU
    processes get id = process_index << 11 | local), so ids cannot index the
    column partition directly."""
    n_dev = mesh.devices.size
    words = meshlib.pad_words_for_mesh(n_words, n_dev)
    per_dev = words // n_dev
    order = {d: i for i, d in enumerate(mesh.devices.flat)}
    pos = sorted(order[d] for d in jax.local_devices() if d in order)
    # the word partition assumes each process owns one contiguous stretch of
    # mesh positions (true of jax.devices() order); fail
    # loudly if a topology ever violates it
    assert pos and pos == list(range(pos[0], pos[-1] + 1)), (
        f"non-contiguous local mesh positions {pos}: the contiguous "
        "column partition does not apply to this topology")
    return pos[0] * per_dev, (pos[-1] + 1) * per_dev


def place_local(mesh: jax.sharding.Mesh, local: np.ndarray):
    """Build a global column-sharded array from this host's column slice.

    ``local`` holds only the local word-column range of a 2-D array (as
    returned by :func:`local_column_range`); the result behaves like the
    full global array for `shard_map` calls.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P(None, meshlib.SAMPLE_AXIS))
    local_devs = sorted(jax.local_devices(), key=lambda d: d.id)
    per_dev = local.shape[1] // len(local_devs)
    n_dev = mesh.devices.size
    global_shape = (local.shape[0], per_dev * n_dev)
    shards = [
        jax.device_put(np.ascontiguousarray(
            local[:, i * per_dev: (i + 1) * per_dev]), d)
        for i, d in enumerate(local_devs)
    ]
    return jax.make_array_from_single_device_arrays(global_shape, sh, shards)


def place_local_planes(mesh: jax.sharding.Mesh, plane0: np.ndarray,
                       plane1: np.ndarray):
    """Two-plane convenience wrapper over :func:`place_local`."""
    return place_local(mesh, plane0), place_local(mesh, plane1)
