"""Pure model math: expected data matrix, likelihoods, priors, metrics.

Equivalents of the reference's L2 math layer
(/root/reference/R/utils.R:29-183, helpers.R:18-49). All functions are pure
jnp, jit/vmap-safe, f32, with full-precision matmuls.

Conventions (match the reference notation): data M is (K, G); P is (K, N)
signatures; E is (N, G) exposures; A is (N,) binary inclusion; sigmasq is (G,)
per-sample noise variance (normal likelihood only).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Clip floor applied to Mhat under the Poisson likelihood to avoid log(0);
# same constant as the reference (utils.R:100).
MHAT_FLOOR = 1e-6
_HALF_LOG_2PI = 0.9189385332046727  # log(sqrt(2*pi))


def dot_f32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """f32 matmul at full precision.

    The Gibbs conditionals consume these products inside log-densities and
    acceptance ratios, so bf16-pass matmuls (the backend default) are not
    acceptable (nor TF32 on the GPU); N is small, making the extra passes
    negligible next to
    the elementwise K×G work.
    """
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32)


def mhat(P: jnp.ndarray, A: jnp.ndarray, E: jnp.ndarray) -> jnp.ndarray:
    """Expected data matrix ``P @ diag(A) @ E`` → (K, G).

    Parity: get_Mhat_ (utils.R:29-49). The diag product is fused as a
    column-scale of P so the device sees a single (K,N)x(N,G) matmul.
    """
    return dot_f32(P * A[None, :], E)


def poisson_loglik_mat(M: jnp.ndarray, Mh: jnp.ndarray) -> jnp.ndarray:
    """Elementwise Poisson log-likelihood log dPois(M | max(Mh, 1e-6)) → (K, G).

    Parity: get_loglik_ poisson branch (utils.R:98-106). Uses lgamma(M+1) for
    the log-factorial term.
    """
    lam = jnp.maximum(Mh, MHAT_FLOOR)
    return M * jnp.log(lam) - lam - jax.lax.lgamma(M + 1.0)


def normal_loglik_mat(
    M: jnp.ndarray, Mh: jnp.ndarray, sigmasq: jnp.ndarray
) -> jnp.ndarray:
    """Elementwise Normal log-likelihood → (K, G).

    ``sigmasq`` may be (G,) (broadcast across rows, as in utils.R:79-86) or a
    full (K, G) matrix (the MH acceptance path passes pmax(Mhat,1)).
    """
    if sigmasq.ndim == 1:
        sigmasq = sigmasq[None, :]
    resid = M - Mh
    return -0.5 * resid * resid / sigmasq - 0.5 * jnp.log(sigmasq) - _HALF_LOG_2PI


def loglik_mat(
    M: jnp.ndarray,
    Mh: jnp.ndarray,
    likelihood: str,
    sigmasq: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Dispatch on static likelihood string. Parity: get_loglik_ (utils.R:62-112)."""
    if likelihood == "poisson":
        return poisson_loglik_mat(M, Mh)
    return normal_loglik_mat(M, Mh, sigmasq)


def truncnorm_logpdf(
    x: jnp.ndarray, mu: jnp.ndarray, sigmasq: jnp.ndarray
) -> jnp.ndarray:
    """log pdf of Normal(mu, sigmasq) truncated to [0, inf).

    Parity: truncnorm::dtruncnorm use in get_logpost_ (utils.R:134-145).
    log Z = log P(X >= 0) computed via log_ndtr for tail robustness.
    """
    sd = jnp.sqrt(sigmasq)
    z = (x - mu) / sd
    log_norm = -0.5 * z * z - jnp.log(sd) - _HALF_LOG_2PI
    # P(X >= 0) = P(Z >= -mu/sd) = ndtr(mu/sd)
    log_tail = _log_ndtr(mu / sd)
    return jnp.where(x >= 0, log_norm - log_tail, -jnp.inf)


def _log_ndtr(x: jnp.ndarray) -> jnp.ndarray:
    """Numerically robust log of the standard normal CDF."""
    return jax.scipy.special.log_ndtr(x)


def truncnorm_logpdf_delta(x_new, x_old, mu, sigmasq):
    """truncnorm_logpdf(x_new, mu, sigmasq) - truncnorm_logpdf(x_old, ...)
    for x_new, x_old >= 0 (truncated draws by construction): the -log(sd)
    and -log Phi(mu/sd) normalizers are identical and cancel, leaving the
    pure quadratic. Saves two log_ndtr + two log evaluations per element of
    the large-G MH acceptance rows."""
    zn = x_new - mu
    zo = x_old - mu
    return -0.5 * (zn * zn - zo * zo) / sigmasq


def exponential_logpdf(x: jnp.ndarray, rate: jnp.ndarray) -> jnp.ndarray:
    return jnp.where(x >= 0, jnp.log(rate) - rate * x, -jnp.inf)


def gamma_logpdf(
    x: jnp.ndarray, shape: jnp.ndarray, rate: jnp.ndarray
) -> jnp.ndarray:
    return (
        shape * jnp.log(rate)
        - jax.lax.lgamma(shape)
        + (shape - 1.0) * jnp.log(x)
        - rate * x
    )


def logprior_PE(P, E, prior: str, prior_params: dict) -> jnp.ndarray:
    """Sum of elementwise prior log-pdfs of P and E under the model's prior
    family. Parity: get_logpost_ prior block (utils.R:131-175)."""
    if prior == "truncnormal":
        lp = jnp.sum(truncnorm_logpdf(P, prior_params["Mu_p"], prior_params["Sigmasq_p"]))
        le = jnp.sum(truncnorm_logpdf(E, prior_params["Mu_e"], prior_params["Sigmasq_e"]))
    elif prior == "exponential":
        lp = jnp.sum(exponential_logpdf(P, prior_params["Lambda_p"]))
        le = jnp.sum(exponential_logpdf(E, prior_params["Lambda_e"]))
    else:  # gamma
        lp = jnp.sum(gamma_logpdf(P, prior_params["Alpha_p"], prior_params["Beta_p"]))
        le = jnp.sum(gamma_logpdf(E, prior_params["Alpha_e"], prior_params["Beta_e"]))
    return lp + le


def rmse(M: jnp.ndarray, Mh: jnp.ndarray) -> jnp.ndarray:
    """Root mean squared error (utils.R:437)."""
    d = Mh - M
    return jnp.sqrt(jnp.mean(d * d))


def padded_kl(Mh: jnp.ndarray, M: jnp.ndarray) -> jnp.ndarray:
    """KL divergence sum(M log(M/Mhat)) with both padded to >= 1e-6
    (padded_KL_, utils.R:467-471)."""
    Mh = jnp.maximum(Mh, 1e-6)
    Mp = jnp.maximum(M, 1e-6)
    return jnp.sum(Mp * (jnp.log(Mp) - jnp.log(Mh)))


def metric_constants(likelihood: str, M: jnp.ndarray) -> dict:
    """Data-only terms of the per-iteration metrics, hoisted out of the scan.

    The Poisson log-factorial sum(lgamma(M+1)) (utils.R:100) and the
    padded-KL entropy sum(Mp log Mp) (utils.R:467-471) depend only on the
    data, yet the naive metrics row recomputes both every iteration — a full
    (K, G) transcendental pass each (~150M redundant lgammas per ensemble
    iteration at 64 chains x 96x25k). Computed once per chunk before the
    lax.scan and threaded into ``_metrics_row``; under a G-sharded mesh the
    reductions psum once per chunk instead of once per iteration.
    """
    Mp = jnp.maximum(M, 1e-6)
    consts = {"mlogm_sum": jnp.sum(Mp * jnp.log(Mp))}
    if likelihood == "poisson":
        consts["lgamma_sum"] = jnp.sum(jax.lax.lgamma(M + 1.0))
    return consts


def bic(loglik: jnp.ndarray, n_params: jnp.ndarray, G: int) -> jnp.ndarray:
    """BIC = -2 loglik + n_params log(G) (utils.R:432)."""
    return -2.0 * loglik + n_params * jnp.log(jnp.float32(G))


def n_params_of(A: jnp.ndarray, K: int, G: int) -> jnp.ndarray:
    """Effective parameter count sum(A) * (G + K) (utils.R:424)."""
    return jnp.sum(A) * (G + K)


def renormalize(P: jnp.ndarray, E: jnp.ndarray):
    """Rescale so columns of P sum to 1, preserving P@E (helpers.R:35-49)."""
    s = jnp.sum(P, axis=0)  # (N,)
    safe = jnp.where(s > 0, s, 1.0)
    return P / safe[None, :], E * safe[:, None]


def logsumexp2(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """log(exp(a) + exp(b)) stable; parity with sumLog (sample_params.R:199-206)."""
    hi = jnp.maximum(a, b)
    lo = jnp.minimum(a, b)
    return hi + jnp.log1p(jnp.exp(lo - hi))
