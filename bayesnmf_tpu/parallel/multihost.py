"""Multi-host execution: jax.distributed bootstrap + cross-host global meshes.

No reference equivalent (the R package is one process on one core; SURVEY.md
§2.3). Layout doctrine (SURVEY.md §5 "Distributed communication backend"):

- the **chain axis is data-parallel across hosts** — independent Gibbs
  chains never communicate inside the hot loop, so the only cross-host
  traffic is chunk-boundary metric gathers and checkpoint writes;
- the **g (genomes) axis is sharded within a host slice**, so the sweeps'
  cross-G reductions (the `mu_num`/`denom` contractions of sample_Pn.R:132-152
  and the A-sweep loglik sums) become psums between the devices of one
  host (NVLink on a GPU host), never across the network.

Hosts call :func:`initialize` once, build one :func:`global_mesh`, and feed
it to ``parallel.ensemble.ChainEnsemble(mesh=...)`` /
``parallel.chains.make_sharded_chain_runner``; GSPMD handles the rest.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import CHAIN_AXIS, G_AXIS, make_mesh

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None) -> bool:
    """Bootstrap jax.distributed across hosts. Idempotent.

    Under a launcher that provides a cluster environment (SLURM / Open
    MPI), call with no arguments and JAX auto-detects the topology; without
    one, pass ``coordinator_address`` (e.g. ``localhost:<port>``),
    ``num_processes`` and ``process_id``. A bare call outside any cluster is
    a no-op: returns False and leaves JAX in local mode.
    """
    global _initialized
    if _initialized:
        return True
    if coordinator_address is None and num_processes is None:
        # Auto-detected topology (or plain single-process). jax refuses to
        # initialize after first backend use and when no cluster env exists;
        # both mean "run local", which is the right single-host fallback.
        try:
            jax.distributed.initialize()
        except Exception:
            return False
    else:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
    _initialized = True
    return True


def n_hosts() -> int:
    return jax.process_count()


def global_mesh(n_chain: Optional[int] = None,
                n_g: Optional[int] = None) -> Mesh:
    """(chain, g) mesh over ALL devices of ALL hosts.

    The g axis is constrained to live inside one host slice so its
    collectives stay inside a host; the chain axis spans hosts (order
    chosen by mesh_utils.create_hybrid_device_mesh to keep cross-host hops
    on the outer axis). Single-host falls back to the plain local mesh.
    """
    devs = jax.devices()
    n = len(devs)
    hosts = jax.process_count()
    per_host = n // hosts
    if n_chain is None and n_g is None:
        n_chain, n_g = n, 1
    elif n_chain is None:
        n_chain = n // n_g
    elif n_g is None:
        n_g = n // n_chain
    if n_chain * n_g != n:
        raise ValueError(f"mesh {n_chain}x{n_g} != {n} global devices")
    if hosts == 1:
        return make_mesh(n_chain, n_g, devices=devs)
    if n_g > per_host or per_host % n_g != 0:
        raise ValueError(
            f"g axis ({n_g}) must divide one host's device count "
            f"({per_host}) so its collectives stay inside one host")
    if n_chain % hosts != 0:
        raise ValueError(
            f"chain axis ({n_chain}) must be a multiple of the host count "
            f"({hosts}) for host-data-parallel chains")
    from jax.experimental import mesh_utils

    try:
        arr = mesh_utils.create_hybrid_device_mesh(
            (n_chain // hosts, n_g), (hosts, 1), devices=devs)
    except ValueError:
        # Backends without slice topology (multi-process CPU, some
        # single-slice pods): group by process explicitly — the g axis stays
        # inside one process's devices, the chain axis spans processes on
        # the outer (cross-host) dimension, same layout doctrine by hand.
        devs_sorted = sorted(devs, key=lambda d: (d.process_index, d.id))
        arr = np.asarray(devs_sorted).reshape(
            hosts, per_host // n_g, n_g).reshape(n_chain, n_g)
    return Mesh(arr, (CHAIN_AXIS, G_AXIS))


def shard_data(data, mesh: Mesh):
    """Build the global (K, G) data array, G-sharded over the mesh.

    Each host passes its full local copy (96 x G counts are small) or, for
    very large G, a callback-backed loader; only this host's shards are
    materialized on its devices.
    """
    data = np.asarray(data, np.float32)
    sh = NamedSharding(mesh, P(None, G_AXIS))
    return jax.make_array_from_callback(data.shape, sh,
                                        lambda idx: data[idx])
