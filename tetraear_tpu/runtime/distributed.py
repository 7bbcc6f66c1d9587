"""Multi-host initialization and how the TETRA mesh maps onto hosts.

Single-host multi-device needs nothing from this module: ``jax.devices()``
already sees every card on the host and collectives run over the host's
interconnect (runtime.sharding).  Crossing hosts additionally needs the
JAX distributed runtime so all processes agree on the global device set;
this module wraps that initialization and documents the layout.

Layout (how the sharded demod scales across hosts)
--------------------------------------------------
The mesh axes are ``carrier`` x ``time`` (runtime.sharding.make_mesh):

  * The **carrier** axis is communication-free — each device owns a
    carrier slice end to end.  Lay it across hosts (outer mesh
    dimension): zero cross-host traffic in steady state.
  * The **time** axis exchanges one overlap-save halo per segment with
    the left neighbour (``ppermute``) — keep it *inside* a host so halos
    ride the intra-host links.  ``make_host_mesh`` below builds exactly
    this layout: mesh shape (n_hosts * c_per_host, t_local) with the
    time axis mapped to intra-host device order.
  * The only cross-host collective left is the scalar ``psum`` of sync/
    CRC statistics — latency-insensitive.

Host IQ ingestion shards naturally: each host reads (or receives from
its SDR front-ends) only the band slice its carriers need, so input
bandwidth also scales with hosts.

Environment contract: set ``TETRAEAR_COORDINATOR`` (host:port of process
0), ``TETRAEAR_NUM_PROCESSES`` and ``TETRAEAR_PROCESS_ID``, or pass the
same values as arguments; nothing is auto-detected.
"""

from __future__ import annotations

import logging
import os

import numpy as np

logger = logging.getLogger(__name__)

_initialized = False


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Initialize the JAX distributed runtime for multi-host meshes.

    Arguments default to the TETRAEAR_* environment variables; with none
    set, this is a no-op and the process stays single-host.  Returns True when the distributed
    runtime is (already or newly) initialized.
    """
    global _initialized
    import jax

    if _initialized:
        return True
    coordinator = coordinator or os.environ.get("TETRAEAR_COORDINATOR")
    num_processes = num_processes if num_processes is not None else \
        _int_env("TETRAEAR_NUM_PROCESSES")
    process_id = process_id if process_id is not None else \
        _int_env("TETRAEAR_PROCESS_ID")

    if coordinator is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id)
    _initialized = True
    logger.info("jax.distributed initialized: process %d/%d via %s",
                jax.process_index(), jax.process_count(), coordinator)
    return True


def _int_env(name: str) -> int | None:
    v = os.environ.get(name)
    return int(v) if v else None


def make_host_mesh(carriers_per_host: int = 1):
    """Mesh laid out so the time axis stays inside a host (module
    docstring).

    Devices are ordered host-major by jax.devices(); reshaping to
    (n_hosts * carriers_per_host, devices_per_host // carriers_per_host)
    puts each time row inside one host.  Works identically on a
    single-host virtual mesh (n_hosts = 1).
    """
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    n_local = max(1, len(devices) // max(1, _process_count()))
    t_local = max(1, n_local // carriers_per_host)
    n_c = len(devices) // t_local
    dev = np.asarray(devices[:n_c * t_local]).reshape(n_c, t_local)
    return Mesh(dev, axis_names=("carrier", "time"))


def _process_count() -> int:
    import jax
    try:
        return jax.process_count()
    except Exception:
        return 1
