"""Multi-host scaffolding: distributed initialization + host-aware meshes.

The single-controller code in this package (sharded_semi_dense,
distributed_ba) is written against an abstract ``Mesh`` and works
unchanged over a multi-host device set — what a multi-host launch
additionally needs is (1) runtime initialization on every process and
(2) a mesh whose axis layout keeps the heavy collectives on the
intra-host links (NVLink between the GPUs of one host) instead of the
inter-host network.  This module provides both; it degenerates
gracefully to the single-process case (validated by that path, the
virtual-device mesh tests and a real two-process test).

Collective-placement rule encoded here: the landmark axis of the
distributed BA psum and the pixel-column axis of the sharded sweep both
reduce per-iteration megabyte-scale blocks — they go on the FAST
(intra-host, NVLink) mesh dimension; anything sharded across hosts rides
the network and should only move bulk data that amortizes (frame
batches).
"""

import os

import numpy as np
import jax


def initialize_distributed(coordinator_address=None, num_processes=None,
                           process_id=None):
    """Initialize the JAX distributed runtime for a multi-host launch.

    Arguments default from the standard env vars
    (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID) and the
    call is a NO-OP for single-process runs (num_processes in (None, 1))
    so the same entry point works everywhere.

    Returns (process_id, num_processes).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))

    if num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    return process_id, num_processes


def make_host_mesh(intra_axis="shard", inter_axis="host"):
    """Build a 2-D (host, intra-host) mesh over ALL devices.

    The fast ``intra_axis`` spans each host's local devices (NVLink) — put
    the per-iteration collectives there: the landmark-marginalized
    camera-system psum of distributed_ba and the regularization halo of
    the sharded sweep.  The slow ``inter_axis`` spans hosts (network) — use
    it for frame/sequence parallelism where transfers amortize over a
    whole pipeline step.

    Single-host processes get a (1, n_local) mesh, so code written
    against this layout runs unchanged in CI.

    Devices are grouped EXPLICITLY by ``process_index`` (a
    bare reshape assumes jax.devices() orders contiguously by process,
    which device-id ordering does not guarantee on all topologies — a
    straddled row would put the per-iteration collectives on the network).
    """
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    n_local = jax.local_device_count()
    devices = np.asarray(devs).reshape(-1, n_local)
    for row in devices:
        assert len({d.process_index for d in row}) == 1, (
            "uneven devices per process")
    return jax.sharding.Mesh(devices, (inter_axis, intra_axis))


def local_slice(mesh, global_array_len, inter_axis="host"):
    """(start, length) of this host's block of an inter-host-sharded
    leading axis (e.g. which frames of a sequence this host ingests).

    The remainder of a non-divisible length goes one-each to the first
    hosts (a floor division would silently drop the last
    ``len % n_hosts`` items)."""
    n_hosts = mesh.shape[inter_axis]
    idx = jax.process_index()
    per, rem = divmod(global_array_len, n_hosts)
    start = idx * per + min(idx, rem)
    return start, per + (1 if idx < rem else 0)
