"""bayesnmf_tpu — Bayesian NMF with learned rank, on accelerators via JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
jennalandy/bayesNMF R package: Gibbs sampling for M ≈ P diag(A) E with
Poisson/Normal likelihoods, truncnormal/exponential/gamma priors, optional
Metropolis-Hastings accelerated updates, and SBFI/BFI/BIC automatic rank
learning — engineered as jitted scans over device meshes with vmapped chain
ensembles rather than a single-threaded in-place loop.
"""

from .config import (  # noqa: F401
    ConvergenceControl,
    ModelError,
    ModelSpec,
    RunConfig,
    default_MH,
)

__version__ = "0.2.0"


def new_convergence_control(**kw):
    """R-compat alias for ConvergenceControl (convergence.R:16-45)."""
    return ConvergenceControl(**kw)


def __getattr__(name):
    # Lazy imports keep `import bayesnmf_tpu` light; heavy modules load on use.
    if name in ("GibbsSampler", "fit", "bayesNMF"):
        from .models.sampler import GibbsSampler, fit

        return {"GibbsSampler": GibbsSampler, "fit": fit,
                "bayesNMF": fit}[name]
    if name in ("get_cosmic", "download_cosmic", "get_cosmic_colors"):
        from .utils import cosmic

        return getattr(cosmic, name)
    if name in ("hungarian_assignment", "pairwise_sim"):
        from .utils import assignment

        return {"hungarian_assignment": assignment.hungarian_assignment,
                "pairwise_sim": assignment.pairwise_cosine}[name]
    if name == "summarize_samplers":
        from .utils.postprocessing import summarize_samplers

        return summarize_samplers
    if name == "ChainEnsemble":
        from .parallel.ensemble import ChainEnsemble

        return ChainEnsemble
    raise AttributeError(name)
