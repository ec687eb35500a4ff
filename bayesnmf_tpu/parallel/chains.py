"""Vmapped chain ensembles, optionally sharded over a device mesh.

No reference equivalent (the R package deliberately runs one chain,
advanced.qmd:56); this is the throughput axis of the design: thousands of
independent chains per chip via vmap, data-parallel over the ``chain`` mesh
axis, with per-chain RNG streams from threefry key folding.
"""

from __future__ import annotations

from functools import partial

import jax

from ..config import ModelSpec
from ..models import gibbs


def init_chain_states(spec: ModelSpec, hp: dict, data, key, n_chains: int,
                      init_params=None, init_prior_params=None):
    """Independent initial states for ``n_chains`` chains (vmapped)."""
    keys = jax.random.split(key, n_chains)
    return jax.vmap(
        lambda k: gibbs.init_state(spec, hp, data, k, init_params,
                                   init_prior_params)
    )(keys)


@partial(jax.jit, static_argnames=("spec", "record", "store_E"),
         donate_argnames=("states",))
def run_chunk_chains(spec: ModelSpec, data, hp: dict, states: dict, temps,
                     accept_all, record: str = "basic", store_E: bool = True):
    """Run one chunk for every chain.

    ``accept_all`` is a per-chain bool vector (chains converge independently,
    flipping from the warmup accept-all regime to true MH at different
    times); data and the temperature ladder are shared.

    ``store_E=False`` drops the stacked E history from the outputs *inside*
    the jitted program, so XLA dead-code-eliminates the (chains, chunk, N, G)
    stack — at 100k genomes that stack dominates device memory. ``record='metrics'``
    drops P/A too (pure throughput mode).
    """

    from ..ops import math as m

    # data-only metric reductions: once per chunk, shared by every chain
    consts = m.metric_constants(spec.likelihood, data)

    def one_chain(state, acc):
        def body(st, temp):
            return gibbs.gibbs_step(spec, data, hp, st, temp, acc, record,
                                    consts)

        return jax.lax.scan(body, state, temps)

    states, samples = jax.vmap(one_chain)(states, accept_all)
    if not store_E and "E" in samples:
        del samples["E"]
    return states, samples


def make_sharded_chain_runner(spec: ModelSpec, mesh, n_chains: int,
                              record: str = "basic", store_E: bool = True):
    """Compile a chunk runner whose chain states + G axes are mesh-sharded.

    Returns (init_fn, run_fn):
      init_fn(hp, data, key) -> sharded states
      run_fn(data, hp, states, temps, accept_all) -> (states, samples)
    GSPMD inserts the psums for the G-reductions inside the sweeps.
    ``record``/``store_E`` prune the sample stack like run_chunk_chains.
    """
    from . import mesh as M

    st_sh = M.state_shardings(spec, mesh, chains=True)
    data_sh = M.data_sharding(mesh)
    out_sh = M.sample_out_shardings(spec, mesh, chains=True, record=record,
                                    store_E=store_E)

    def _init(hp, data, key):
        states = init_chain_states(spec, hp, data, key, n_chains)
        return jax.device_put(states, st_sh)

    run = jax.jit(
        lambda data, hp, states, temps, acc: run_chunk_chains(
            spec, data, hp, states, temps, acc, record, store_E),
        in_shardings=(data_sh, None, st_sh, None, None),
        out_shardings=(st_sh, out_sh),
        donate_argnums=(2,),
    )

    def _run(data, hp, states, temps, accept_all):
        data = jax.device_put(data, data_sh)
        return run(data, hp, states, temps, accept_all)

    return _init, _run
