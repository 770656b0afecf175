"""Device-mesh helpers.

The framework's parallel axes:
- ``pixel`` — data parallelism over pixel blocks (semi-dense depth maps,
  DVO residual grids).  Zero-communication except halo-free reductions.
- ``point`` — landmark sharding for distributed bundle adjustment; the
  reduced camera system is psum-reduced over this axis (an intra-host
  NVLink collective).

One physical axis serves both in round 1 (they are never active in the same
program); richer meshes (pixel x point) drop in without API changes.
"""

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec, NamedSharding


def make_mesh(devices=None, axis_name="shard"):
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def default_mesh():
    return make_mesh()


def row_sharding(mesh, axis_name="shard"):
    """Shard a 2-D map along its first (row) axis."""
    return NamedSharding(mesh, PartitionSpec(axis_name, None))


def replicated(mesh):
    return NamedSharding(mesh, PartitionSpec())
