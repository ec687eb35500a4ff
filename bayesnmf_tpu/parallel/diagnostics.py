"""Cross-chain MCMC convergence diagnostics: split-R̂ and effective sample size.

No reference equivalent: the R package runs exactly one chain and its
convergence heuristic is a windowed %-change rule on a scalar metric
(/root/reference/R/convergence.R:60-154; advanced.qmd:56 states multiple
chains are deliberately not used). This design runs chain *ensembles*
(parallel/chains.py), which unlocks the modern gold-standard diagnostics:
rank-normalized split-R̂ and bulk/tail ESS (Vehtari, Gelman, Simpson,
Carpenter & Bürkner 2021, "Rank-normalization, folding, and localization:
an improved R̂ for assessing convergence of MCMC").

Everything here is pure jnp on statically-shaped (n_chains, n_draws[, ...])
stacks — jit-friendly, batches over trailing parameter axes, and runs on
device (the FFT autocorrelation rides the VPU; no host round-trips until the
final scalars).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "split_rhat",
    "rank_normalize",
    "ess",
    "ess_bulk",
    "ess_tail",
    "rhat",
    "ensemble_diagnostics",
]


def _split_chains(x):
    """(C, T, ...) -> (2C, T//2, ...), dropping a trailing odd draw."""
    C, T = x.shape[0], x.shape[1]
    half = T // 2
    first = x[:, :half]
    second = x[:, half: 2 * half]
    return jnp.concatenate([first, second], axis=0)


def split_rhat(x):
    """Split-R̂ over a (n_chains, n_draws[, ...]) stack (no rank-normalization).

    Returns the potential scale reduction factor per trailing-axis element.
    Values ≲ 1.01 indicate mixing (Vehtari et al. 2021 threshold).
    """
    x = jnp.asarray(x, jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
    z = _split_chains(x)
    m, t = z.shape[0], z.shape[1]
    chain_mean = jnp.mean(z, axis=1)                       # (2C, ...)
    chain_var = jnp.var(z, axis=1, ddof=1)                 # (2C, ...)
    B = t * jnp.var(chain_mean, axis=0, ddof=1)            # between
    W = jnp.mean(chain_var, axis=0)                        # within
    var_plus = (t - 1) / t * W + B / t
    return jnp.sqrt(var_plus / jnp.maximum(W, 1e-300))


def rank_normalize(x):
    """Rank-normalize draws across ALL chains jointly (fractional ranks →
    normal quantiles), the 'rank-normalization' step of Vehtari et al. 2021.

    Static-shape friendly: double-argsort ranks over the flattened
    (chain, draw) axes, batched over trailing parameter axes.
    """
    x = jnp.asarray(x)
    C, T = x.shape[0], x.shape[1]
    flat = x.reshape((C * T,) + x.shape[2:])
    order = jnp.argsort(flat, axis=0)
    ranks = jnp.argsort(order, axis=0).astype(jnp.float32)  # 0..CT-1
    # fractional ranks with the (r - 3/8) / (S + 1/4) Blom offset
    frac = (ranks + 1.0 - 0.375) / (C * T + 0.25)
    z = jax.scipy.special.ndtri(frac)
    return z.reshape(x.shape)


def _autocov_fft(z):
    """Per-chain autocovariance via FFT, biased (divided by T), over
    (C, T, ...) along axis 1."""
    T = z.shape[1]
    zc = z - jnp.mean(z, axis=1, keepdims=True)
    nfft = 2 ** int(np.ceil(np.log2(2 * T)))
    f = jnp.fft.rfft(zc, n=nfft, axis=1)
    acov = jnp.fft.irfft(f * jnp.conj(f), n=nfft, axis=1)[:, :T]
    return jnp.real(acov) / T


def ess(x):
    """Effective sample size of a (n_chains, n_draws[, ...]) stack using the
    multi-chain autocorrelation estimator with Geyer's initial monotone
    positive sequence (Vehtari et al. 2021, eq. 10; Stan's reference
    algorithm), vectorized over trailing axes with static shapes.
    """
    x = jnp.asarray(x, jnp.float32)
    z = _split_chains(x)
    m, t = z.shape[0], z.shape[1]
    acov = _autocov_fft(z)                                  # (m, t, ...)
    chain_var = acov[:, 0] * t / (t - 1.0)                  # (m, ...)
    mean_var = jnp.mean(chain_var, axis=0)                  # W
    var_plus = mean_var * (t - 1.0) / t + jnp.var(
        jnp.mean(z, axis=1), axis=0, ddof=1)

    # combined autocorrelation rho_t (eq. 10): 1 - (W - mean acov_t)/var_plus
    rho = 1.0 - (mean_var[None] - jnp.mean(acov, axis=0)) / jnp.maximum(
        var_plus[None], 1e-300)                             # (t, ...)

    # Geyer pair sums P_k = rho_{2k} + rho_{2k+1}; keep while positive,
    # then enforce monotone non-increase. Static-shape via cumulative masks.
    n_pairs = t // 2
    even = rho[0: 2 * n_pairs: 2]
    odd = rho[1: 2 * n_pairs: 2]
    pair = even + odd                                       # (n_pairs, ...)
    positive = pair > 0.0
    keep = jnp.cumprod(positive, axis=0).astype(bool)       # initial positive seq
    pair = jnp.where(keep, pair, 0.0)
    # monotone: running minimum over the kept prefix
    pair = jax.lax.associative_scan(jnp.minimum, pair, axis=0)
    pair = jnp.maximum(pair, 0.0)
    # tau = -1 + 2 * sum_k P_k  (rho_0 = 1 included via P_0)
    tau = -1.0 + 2.0 * jnp.sum(pair, axis=0)
    tau = jnp.maximum(tau, 1.0 / jnp.log10(jnp.float32(m * t)))
    return m * t / tau


def ess_bulk(x):
    """Bulk-ESS: ESS of the rank-normalized draws."""
    return ess(rank_normalize(x))


def ess_tail(x):
    """Tail-ESS: min ESS of the 5% / 95% quantile indicator functions,
    measuring tail-quantile reliability. The indicators are used directly
    (rank-normalizing a binary variable would order its ties arbitrarily and
    inject spurious autocorrelation)."""
    x = jnp.asarray(x)
    q05 = jnp.quantile(x.reshape((-1,) + x.shape[2:]), 0.05, axis=0)
    q95 = jnp.quantile(x.reshape((-1,) + x.shape[2:]), 0.95, axis=0)
    i05 = (x <= q05).astype(jnp.float32)
    i95 = (x <= q95).astype(jnp.float32)
    return jnp.minimum(ess(i05), ess(i95))


def rhat(x):
    """Rank-normalized split-R̂: max of the bulk and folded (median-absolute-
    deviation) variants — the headline diagnostic of Vehtari et al. 2021."""
    x = jnp.asarray(x)
    bulk = split_rhat(rank_normalize(x))
    med = jnp.median(x.reshape((-1,) + x.shape[2:]), axis=0)
    folded = split_rhat(rank_normalize(jnp.abs(x - med)))
    return jnp.maximum(bulk, folded)


# ---------------------------------------------------------------------------
# ensemble-level report
# ---------------------------------------------------------------------------


def ensemble_diagnostics(ensemble, metrics=("logposterior", "loglikelihood",
                                            "RMSE", "rank"),
                         n_draws: int | None = None):
    """Convergence report for a ChainEnsemble: per-metric rank-normalized
    split-R̂ and bulk/tail ESS over the retained inference window.

    Returns a pandas DataFrame with one row per metric. Chains that learn
    different ranks are a known failure mode of naive multi-chain Bayesian
    NMF (the reason the reference avoids ensembles, advanced.qmd:56); a large
    R̂ on ``rank`` detects exactly that, instead of silently averaging over
    incompatible models.
    """
    import pandas as pd

    from ..models.gibbs import METRIC_NAMES

    if n_draws is not None and hasattr(ensemble, "metrics_stack"):
        # each chain's OWN inference window (chains finish at different
        # iterations under compaction; aligning on windows, not global
        # iteration numbers, is what cross-chain R-hat wants anyway)
        rows_all = ensemble.metrics_stack(n_draws)  # (C, n_draws, m)
        keep = ~np.all(np.isnan(rows_all[:, :, 0]), axis=0)
        rows_all = rows_all[:, keep, :]
    else:
        rows_all = np.concatenate(ensemble._metric_rows, axis=1)  # (C, T, m)
        if n_draws is not None:
            rows_all = rows_all[:, -n_draws:, :]
    out = []
    name_to_col = {n: i for i, n in enumerate(METRIC_NAMES)}
    for name in metrics:
        col = name_to_col[name]
        trace = jnp.asarray(rows_all[:, :, col])
        const = bool(np.all(rows_all[:, :, col] == rows_all[:, :1, col]))
        if const:
            # identical across all draws (e.g. fixed rank): R̂ undefined → 1
            out.append({"metric": name, "rhat": 1.0,
                        "ess_bulk": float(trace.size),
                        "ess_tail": float(trace.size), "constant": True})
            continue
        out.append({
            "metric": name,
            "rhat": float(rhat(trace)),
            "ess_bulk": float(ess_bulk(trace)),
            "ess_tail": float(ess_tail(trace)),
            "constant": False,
        })
    return pd.DataFrame(out)
