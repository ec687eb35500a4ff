"""Device mesh + sharding layout for the sampler state.

New first-class component vs the reference (SURVEY.md §2.3): the reference is
a single R process; here chains are data-parallel over a ``chain`` mesh axis
and the sample dimension G (genomes) is sharded over a ``g`` axis so the
(N, G) exposure table, the (K, G) data/Mhat workspaces, and the latent-count
partial sums live distributed. GSPMD inserts the collectives: the P-sweep's
residual contractions over G and the A-sweep's loglik sums become psums
between devices; everything else is local.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CHAIN_AXIS = "chain"
G_AXIS = "g"


def make_mesh(n_chain: Optional[int] = None, n_g: Optional[int] = None,
              devices=None) -> Mesh:
    """Build a (chain, g) mesh over the available devices.

    Defaults: all devices on the chain axis (pure chain-parallel ensembles).
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if n_chain is None and n_g is None:
        n_chain, n_g = n, 1
    elif n_chain is None:
        n_chain = n // n_g
    elif n_g is None:
        n_g = n // n_chain
    if n_chain * n_g != n:
        raise ValueError(f"mesh {n_chain}x{n_g} != {n} devices")
    dev = np.asarray(devices).reshape(n_chain, n_g)
    return Mesh(dev, (CHAIN_AXIS, G_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Data M (K, G): G sharded, replicated across chains."""
    return NamedSharding(mesh, P(None, G_AXIS))


def state_shardings(spec, mesh: Mesh, chains: bool = True):
    """NamedSharding pytree matching a (possibly chain-batched) sampler state.

    Layout: every G-sized trailing axis is sharded over ``g``; the leading
    chain axis (if ``chains``) is sharded over ``chain``; K/N axes are
    replicated (N is small).
    """
    c = (CHAIN_AXIS,) if chains else ()

    def ns(*axes):
        return NamedSharding(mesh, P(*c, *axes))

    rep2 = ns(None, None)
    gcol = ns(None, G_AXIS)
    gvec = ns(G_AXIS)
    scal = ns()

    params = {"P": rep2, "E": gcol, "A": ns(None), "R": scal}
    if spec.needs_Z:
        params["Zsum_g"] = rep2
        params["Zsum_k"] = gcol
    if spec.needs_sigmasq:
        params["sigmasq"] = gvec

    if spec.prior == "truncnormal":
        prior = {"Mu_p": rep2, "Sigmasq_p": rep2, "Mu_e": gcol, "Sigmasq_e": gcol}
    elif spec.prior == "exponential":
        prior = {"Lambda_p": rep2, "Lambda_e": gcol}
    else:
        prior = {"Alpha_p": rep2, "Beta_p": rep2, "Alpha_e": gcol, "Beta_e": gcol}
    if spec.needs_sigmasq:
        prior["Alpha_sig"] = gvec
        prior["Beta_sig"] = gvec

    state = {"params": params, "prior": prior, "key": ns(None), "iter": scal}
    if spec.MH:
        state["acc_P"] = rep2
        state["acc_E"] = gcol
    return state


def sample_out_shardings(spec, mesh: Mesh, chains: bool = True,
                         record: str = "basic", store_E: bool = True):
    """Shardings of the per-chunk sample stack (leading scan axis unsharded).

    The pytree must mirror exactly what ``gibbs.gibbs_step`` emits for the
    given ``record`` mode (gibbs.py sample_out construction): 'metrics' emits
    only the metrics rows; 'basic' adds P/E/A; 'full' additionally stacks the
    prior subtree (same per-leaf G layout as ``state_shardings`` with an extra
    scan axis), sigmasq, and the MH acceptance masks — the full-history
    contract of the reference (record_sample, bayesNMF_sampler.R:651-672)
    must hold on a mesh too, not just single-chip.
    """
    c = (CHAIN_AXIS,) if chains else ()

    def ns(*axes):
        return NamedSharding(mesh, P(*c, None, *axes))

    out = {"metrics": ns(None)}
    if record == "metrics":
        return out
    out |= {"P": ns(None, None), "E": ns(None, G_AXIS), "A": ns(None)}
    if record == "full":
        st = state_shardings(spec, mesh, chains=chains)

        def stack_axis(sh: NamedSharding) -> NamedSharding:
            # insert the unsharded scan axis right after the chain prefix
            parts = list(sh.spec)
            parts.insert(1 if chains else 0, None)
            return NamedSharding(mesh, P(*parts))

        out["prior"] = jax.tree.map(stack_axis, st["prior"])
        if spec.needs_sigmasq:
            out["sigmasq"] = ns(G_AXIS)
        if spec.MH:
            out["acc_P"] = ns(None, None)
            out["acc_E"] = ns(None, G_AXIS)
    if not store_E:
        del out["E"]
    return out
