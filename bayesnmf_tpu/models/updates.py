"""Gibbs conditional updates, specialized at trace time on ModelSpec.

Re-design of the reference's L3 sampling layer
(/root/reference/R/sample_Pn.R, sample_En.R, sample_params.R,
sample_priors.R). Key structural differences from the R package, all
distribution-preserving:

  * Incremental Mhat. The reference recomputes two full K×G matmuls per
    column update (sample_Pn.R:136,152) → O(N²KG) per sweep. Here Mhat is
    carried through the sweep and updated with rank-1 terms → O(NKG).
  * The Poisson-Gibbs path samples ALL of P (then all of E) in one
    vectorized conjugate draw: given the latent counts Z, the full
    conditional factorizes elementwise, so the reference's sequential
    n-loop (sample_params.R:56-58) and its joint draw coincide exactly.
  * The MH / normal-likelihood paths keep the exact sequential-over-N
    semantics via lax.fori_loop (column n's conditional depends on the
    freshly updated columns 1..n-1).
  * Latent counts Z are never materialized; only the marginal sums
    consumed downstream are produced (ops/allocation.py).
  * Prior-parameter sweeps are elementwise-independent across (k,n)/(n,g)
    and run as single fused vector ops instead of per-n loops
    (sample_priors.R:150-200).

Documented corrections of reference quirks (we match distributions, not
bugs — see SURVEY.md §7 "hard parts"):
  * sample_Mu_Pn/En pass the posterior *variance* as R's ``sd`` argument
    (sample_priors.R:219,235); we use sd = sqrt(variance).
  * sample_Sigmasq_En uses hyperparameter A_e where B_e is intended in the
    rate (sample_priors.R:267); we use B_e.
  * the NaN-overflow fallback ladder in sample_An references an undefined
    variable (sample_params.R:156); our log-odds/sigmoid formulation cannot
    produce those NaNs, and any residual NaN resolves to p = 1/2.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import ModelSpec
from ..ops import distributions as dist
from ..ops import math as m
from ..ops.allocation import allocate_counts

_EPS = 1e-30


def _bcast_p(hp, name, spec):
    """Hyperprior entry broadcast to (K, N)."""
    return jnp.broadcast_to(jnp.asarray(hp[name], jnp.float32), (spec.K, spec.N))


def _bcast_e(hp, name, spec):
    return jnp.broadcast_to(jnp.asarray(hp[name], jnp.float32), (spec.N, spec.G))


# ---------------------------------------------------------------------------
# prior parameter initialization + Gibbs sweeps (maps C5)
# ---------------------------------------------------------------------------


def init_prior_params(spec: ModelSpec, hp: dict, key) -> dict:
    """Draw prior parameters from their hyperpriors.

    Parity: init_prior_params_ (sample_priors.R:15-141), vectorized over all
    (k,n)/(n,g) at once.
    """
    ks = jax.random.split(key, 4)
    prior = {}
    if spec.prior == "truncnormal":
        prior["Mu_p"] = dist.normal(ks[0], _bcast_p(hp, "m_p", spec), _bcast_p(hp, "s_p", spec))
        prior["Sigmasq_p"] = dist.inv_gamma(ks[1], _bcast_p(hp, "a_p", spec), _bcast_p(hp, "b_p", spec))
        prior["Mu_e"] = dist.normal(ks[2], _bcast_e(hp, "m_e", spec), _bcast_e(hp, "s_e", spec))
        prior["Sigmasq_e"] = dist.inv_gamma(ks[3], _bcast_e(hp, "a_e", spec), _bcast_e(hp, "b_e", spec))
    elif spec.prior == "exponential":
        prior["Lambda_p"] = dist.gamma(ks[0], _bcast_p(hp, "a_p", spec), _bcast_p(hp, "b_p", spec))
        prior["Lambda_e"] = dist.gamma(ks[1], _bcast_e(hp, "a_e", spec), _bcast_e(hp, "b_e", spec))
    else:  # gamma
        prior["Beta_p"] = dist.gamma(ks[0], _bcast_p(hp, "a_p", spec), _bcast_p(hp, "b_p", spec))
        prior["Alpha_p"] = dist.gamma(ks[1], _bcast_p(hp, "c_p", spec), _bcast_p(hp, "d_p", spec))
        prior["Beta_e"] = dist.gamma(ks[2], _bcast_e(hp, "a_e", spec), _bcast_e(hp, "b_e", spec))
        prior["Alpha_e"] = dist.gamma(ks[3], _bcast_e(hp, "c_e", spec), _bcast_e(hp, "d_e", spec))
    if spec.likelihood == "normal":
        # fixed InvGamma(alpha, beta) prior for sigmasq, defaults 3/3
        # (bayesNMF_sampler.R:222-230); these are never resampled.
        prior["Alpha_sig"] = jnp.broadcast_to(jnp.asarray(hp.get("alpha", 3.0), jnp.float32), (spec.G,))
        prior["Beta_sig"] = jnp.broadcast_to(jnp.asarray(hp.get("beta", 3.0), jnp.float32), (spec.G,))
    return prior


def sample_prior_params(spec: ModelSpec, hp: dict, params: dict, prior: dict, key) -> dict:
    """One Gibbs sweep over prior parameters.

    Parity: sample_prior_params_ (sample_priors.R:150-200). All conditionals
    are elementwise-independent, so each is one fused vector op.
    """
    P, E = params["P"], params["E"]
    new = dict(prior)
    ks = jax.random.split(key, 4)
    if spec.prior == "truncnormal":
        S_p, M_p = _bcast_p(hp, "s_p", spec), _bcast_p(hp, "m_p", spec)
        S_e, M_e = _bcast_e(hp, "s_e", spec), _bcast_e(hp, "m_e", spec)
        A_p, B_p = _bcast_p(hp, "a_p", spec), _bcast_p(hp, "b_p", spec)
        A_e, B_e = _bcast_e(hp, "a_e", spec), _bcast_e(hp, "b_e", spec)
        if spec.exact_truncnorm_hypers:
            # Exact non-conjugate conditionals including the TruncNormal
            # normalizer Phi(mu/sigma) (Geweke-validated), via Metropolized
            # conjugate-proposal independence steps: the conjugate
            # normal/inv-gamma (which drop the normalizer,
            # sample_priors.R:214-270) propose, and the Hastings ratio
            # collapses to exactly the Phi ratio — one ndtr per target
            # instead of a ~18-evaluation slice transition. RNG is batched
            # into ONE normal + ONE gamma + ONE uniform launch across the
            # (K,N) and (N,G) target blocks (launches, not FLOPs, dominate).
            K_, N_, G_ = spec.K, spec.N, spec.G
            n_p, n_e = K_ * N_, N_ * G_
            n_t = n_p + n_e
            kz, ku = jax.random.split(key, 2)
            z = jax.random.normal(kz, (2 * n_t,), jnp.float32)
            lu = jnp.log(jax.random.uniform(
                ku, (2 * n_t,), jnp.float32, minval=1.2e-38))
            log_ndtr = jax.scipy.special.log_ndtr

            def mu_step(mu_old, m0, s0, x, sq, z_, lu_):
                den = 1.0 / s0 + 1.0 / sq
                prop = (m0 / s0 + x / sq) / den + jnp.sqrt(1.0 / den) * z_
                sd = jnp.sqrt(sq)
                la = log_ndtr(mu_old / sd) - log_ndtr(prop / sd)
                return jnp.where(lu_ < la, prop, mu_old)

            def sq_step(sq_old, a0, b0, x, mu, z_, lu_):
                # InvGamma(a, b) proposal via the Wilson-Hilferty cube-of-
                # normal Gamma approximation (one normal instead of
                # jax.random.gamma's rejection while_loop), Metropolized in
                # g = b/sigma^2 space where IG(a,b) becomes Gamma(a,1):
                #   log w(g) = log pi(g) - log q_WH(g)
                #            = (a-1)log g - g + z(g)^2/2 + 2 log t(g)
                #              - log Phi(mu/sqrt(b/g))
                # with t = (g/a)^(1/3), z = 3 sqrt(a) (t - c), c = 1-1/(9a).
                # Still an exact transition; WH acceptance is ~99% for a >= 2
                # (default a = N+1.5 here).
                a = a0 + 0.5
                b = b0 + 0.5 * (x - mu) ** 2
                c = 1.0 - 1.0 / (9.0 * a)
                sqa3 = 3.0 * jnp.sqrt(a)
                t_new = c + z_ / sqa3
                g_new = a * t_new ** 3
                ok = g_new > 1e-30
                g_new_s = jnp.maximum(g_new, 1e-30)
                sq_new = b / g_new_s
                g_old = b / jnp.maximum(sq_old, 1e-30)
                t_old = jnp.cbrt(g_old / a)
                z_old = sqa3 * (t_old - c)

                def logw(g, t, zz, sq):
                    return ((a - 1.0) * jnp.log(g) - g + 0.5 * zz * zz
                            + 2.0 * jnp.log(jnp.maximum(t, 1e-30))
                            - log_ndtr(mu / jnp.sqrt(sq)))

                la = jnp.where(
                    ok,
                    logw(g_new_s, t_new, z_, sq_new)
                    - logw(g_old, t_old, z_old, sq_old),
                    -jnp.inf)
                return jnp.where(lu_ < la, sq_new, sq_old)

            z_p, z_e = z[:n_p].reshape(K_, N_), z[n_p:n_t].reshape(N_, G_)
            zg_p = z[n_t:n_t + n_p].reshape(K_, N_)
            zg_e = z[n_t + n_p:].reshape(N_, G_)
            lu_p1 = lu[:n_p].reshape(K_, N_)
            lu_e1 = lu[n_p:n_t].reshape(N_, G_)
            lu_p2 = lu[n_t:n_t + n_p].reshape(K_, N_)
            lu_e2 = lu[n_t + n_p:].reshape(N_, G_)
            new["Mu_p"] = mu_step(prior["Mu_p"], M_p, S_p, P,
                                  prior["Sigmasq_p"], z_p, lu_p1)
            new["Mu_e"] = mu_step(prior["Mu_e"], M_e, S_e, E,
                                  prior["Sigmasq_e"], z_e, lu_e1)
            new["Sigmasq_p"] = sq_step(prior["Sigmasq_p"], A_p, B_p, P,
                                       new["Mu_p"], zg_p, lu_p2)
            new["Sigmasq_e"] = sq_step(prior["Sigmasq_e"], A_e, B_e, E,
                                       new["Mu_e"], zg_e, lu_e2)
        else:
            # Reference-parity mode: plain conjugates dropping the truncation
            # normalizer (sample_priors.R:214-270; with sd=sqrt(var) and the
            # B_e rate corrected).
            num = M_p / S_p + P / prior["Sigmasq_p"]
            den = 1.0 / S_p + 1.0 / prior["Sigmasq_p"]
            new["Mu_p"] = dist.normal(ks[0], num / den, 1.0 / den)
            num_e = M_e / S_e + E / prior["Sigmasq_e"]
            den_e = 1.0 / S_e + 1.0 / prior["Sigmasq_e"]
            new["Mu_e"] = dist.normal(ks[1], num_e / den_e, 1.0 / den_e)
            dp = P - new["Mu_p"]
            new["Sigmasq_p"] = dist.inv_gamma(ks[2], A_p + 0.5, B_p + 0.5 * dp * dp)
            de = E - new["Mu_e"]
            new["Sigmasq_e"] = dist.inv_gamma(ks[3], A_e + 0.5, B_e + 0.5 * de * de)
    elif spec.prior == "exponential":
        # Lambda | x ~ Gamma(a+1, b+x) (sample_priors.R:284-308)
        new["Lambda_p"] = dist.gamma(
            ks[0], _bcast_p(hp, "a_p", spec) + 1.0, _bcast_p(hp, "b_p", spec) + P
        )
        new["Lambda_e"] = dist.gamma(
            ks[1], _bcast_e(hp, "a_e", spec) + 1.0, _bcast_e(hp, "b_e", spec) + E
        )
    else:  # gamma
        # Beta | Alpha, x ~ Gamma(a+Alpha, b+x) (sample_priors.R:323-345),
        # then Alpha | Beta, x via slice sampling (replaces armspp ARMS,
        # sample_priors.R:356-397).
        new["Beta_p"] = dist.gamma(
            ks[0], _bcast_p(hp, "a_p", spec) + prior["Alpha_p"], _bcast_p(hp, "b_p", spec) + P
        )
        new["Alpha_p"] = dist.slice_sample_logconcave(
            ks[1],
            prior["Alpha_p"],
            (
                _bcast_p(hp, "c_p", spec),
                _bcast_p(hp, "d_p", spec),
                jnp.log(jnp.maximum(new["Beta_p"], _EPS)),
                jnp.log(jnp.maximum(P, _EPS)),
            ),
            dist.gamma_shape_cond_logpdf,
        )
        new["Beta_e"] = dist.gamma(
            ks[2], _bcast_e(hp, "a_e", spec) + prior["Alpha_e"], _bcast_e(hp, "b_e", spec) + E
        )
        new["Alpha_e"] = dist.slice_sample_logconcave(
            ks[3],
            prior["Alpha_e"],
            (
                _bcast_e(hp, "c_e", spec),
                _bcast_e(hp, "d_e", spec),
                jnp.log(jnp.maximum(new["Beta_e"], _EPS)),
                jnp.log(jnp.maximum(E, _EPS)),
            ),
            dist.gamma_shape_cond_logpdf,
        )
    return new


# ---------------------------------------------------------------------------
# prior draws of P / E columns (used at init and for excluded signatures)
# ---------------------------------------------------------------------------


def _prior_draw_P(spec: ModelSpec, prior: dict, key):
    """Draw a full (K, N) P from the prior (init_params path, sample_Pn.R:12-29)."""
    if spec.prior == "truncnormal":
        return dist.truncnorm_nonneg(key, prior["Mu_p"], prior["Sigmasq_p"])
    if spec.prior == "exponential":
        return dist.exponential(key, prior["Lambda_p"])
    return dist.gamma(key, prior["Alpha_p"], prior["Beta_p"])


def _prior_draw_E(spec: ModelSpec, prior: dict, key):
    if spec.prior == "truncnormal":
        return dist.truncnorm_nonneg(key, prior["Mu_e"], prior["Sigmasq_e"])
    if spec.prior == "exponential":
        return dist.exponential(key, prior["Lambda_e"])
    return dist.gamma(key, prior["Alpha_e"], prior["Beta_e"])


# ---------------------------------------------------------------------------
# sequential P sweep (normal likelihood and Poisson+MH paths) — maps C7
# ---------------------------------------------------------------------------


def sweep_P(spec: ModelSpec, data, params: dict, prior: dict, Mhat, acc_P, key, accept_all):
    """Sample all N columns of P sequentially from their full conditionals.

    Parity: sample_Pn / sample_Pn_normal / MH_Pn_poisson (sample_Pn.R:11-248)
    with incremental rank-1 Mhat maintenance. Returns (P, Mhat, acc_P, n_nan)
    where n_nan counts MH acceptance ratios that overflowed to NaN and were
    clamped to 0 (the analog of the reference's logged NA-overflow fallback,
    sample_params.R:136-162 — here surfaced as a metrics column).
    """
    E, A = params["E"], params["A"]
    sigmasq = params.get("sigmasq")
    K, N, G = spec.K, spec.N, spec.G
    k_prior_all, k_u_all = jax.random.split(key)
    mh = spec.likelihood == "poisson" and spec.MH
    # prior fallback columns for the whole sweep in ONE vectorized draw
    # (keeps the op chain inside the sequential loop short)
    P_prior = _prior_draw_P(spec, prior, k_prior_all)
    # ONE uniform launch feeds every column's proposal pair (truncated-normal
    # icdf) and MH-acceptance draw — per-column RNG launches dominate the
    # sweep's latency otherwise
    U = jax.random.uniform(k_u_all, (3, N, K), jnp.float32,
                           minval=jnp.float32(1.2e-38))

    def body(n, carry):
        P, Mhat, acc_P, n_nan = carry
        u_col = jax.lax.dynamic_index_in_dim(U, n, axis=1, keepdims=False)
        A_n = jax.lax.dynamic_index_in_dim(A, n, keepdims=False)
        E_n = jax.lax.dynamic_index_in_dim(E, n, axis=0, keepdims=False)  # (G,)
        P_n = jax.lax.dynamic_index_in_dim(P, n, axis=1, keepdims=False)  # (K,)

        # --- full-conditional (or MH-proposal) mean/variance -------------
        # (get_mu_sigmasq_Pn_normal, sample_Pn.R:132-187)
        if mh:
            sig_mat = jnp.maximum(Mhat, m.MHAT_FLOOR)  # proposal: var = mean
        else:
            sig_mat = jnp.broadcast_to(sigmasq[None, :], (K, G))
        Mhat_no_n = Mhat - A_n * jnp.outer(P_n, E_n)
        # mu1/den as shared-input reduces (not dots): XLA sibling-fuses
        # reductions that read the same operands into ONE streaming pass
        # over the (K, G) tensors, while each dot is a separate op that
        # re-reads its operands from device memory — at large G the sweep
        # is bound by those streams
        resid = data - Mhat_no_n
        inv_sig = 1.0 / sig_mat
        mu1 = jnp.sum(resid * inv_sig * E_n[None, :], axis=1)
        den = A_n * jnp.sum(inv_sig * (E_n * E_n)[None, :], axis=1)
        if spec.prior == "exponential":
            Lam_n = jax.lax.dynamic_index_in_dim(prior["Lambda_p"], n, axis=1, keepdims=False)
            den_s = jnp.maximum(den, _EPS)
            mu = (mu1 - Lam_n) / den_s
            var = 1.0 / den_s
        else:  # truncnormal
            Mu_n = jax.lax.dynamic_index_in_dim(prior["Mu_p"], n, axis=1, keepdims=False)
            Sq_n = jax.lax.dynamic_index_in_dim(prior["Sigmasq_p"], n, axis=1, keepdims=False)
            den2 = den + 1.0 / Sq_n
            mu = (mu1 + Mu_n / Sq_n) / den2
            var = 1.0 / den2
        cond_draw = dist.truncnorm_nonneg_from_u(u_col[0], u_col[1], mu, var)

        # prior fallback: excluded signature or all-zero exposure row
        # (sample_Pn.R:12-13, 56)
        prior_col = jax.lax.dynamic_index_in_dim(P_prior, n, axis=1, keepdims=False)
        inactive_E = jnp.sum(E_n * E_n) <= 0.0
        proposal = jnp.where(inactive_E, prior_col, cond_draw)

        if mh:
            # --- elementwise MH correction (MH_Pn_poisson, :199-248) -----
            # rows are independent given E (the Poisson likelihood and the
            # prior factorize over k), so per-row accept/reject is a proper
            # MH update; the Poisson delta needs one fused K×G pass.
            Mhat_prop = Mhat + A_n * jnp.outer(proposal - P_n, E_n)
            lam_old = jnp.maximum(Mhat, m.MHAT_FLOOR)
            lam_new = jnp.maximum(Mhat_prop, m.MHAT_FLOOR)
            d_lam = lam_new - lam_old
            lp_core = data * jnp.log1p(d_lam / lam_old) - d_lam
            if spec.exact_mh:
                # exact Hastings ratio with the true TruncNormal proposal
                # densities. The reverse-move conditional shares Mhat_no_n
                # (Mhat_prop - A_n P'_n⊗E_n == Mhat_no_n), only the
                # state-dependent proposal variance sig' = max(Mhat_prop, ·)
                # differs.
                sig_r = jnp.maximum(Mhat_prop, m.MHAT_FLOOR)
                # reverse-conditional reductions share data/Mhat streams
                # with lp_core's row-sum (sibling fusion): one pass, not three
                inv_sig_r = 1.0 / sig_r
                mu1_r = jnp.sum(resid * inv_sig_r * E_n[None, :], axis=1)
                den_r = A_n * jnp.sum(inv_sig_r * (E_n * E_n)[None, :], axis=1)
                if spec.prior == "exponential":
                    den_rs = jnp.maximum(den_r, _EPS)
                    mu_r = (mu1_r - Lam_n) / den_rs
                    var_r = 1.0 / den_rs
                    lprior_delta = -Lam_n * (proposal - P_n)
                else:
                    den_r2 = den_r + 1.0 / Sq_n
                    mu_r = (mu1_r + Mu_n / Sq_n) / den_r2
                    var_r = 1.0 / den_r2
                    lprior_delta = m.truncnorm_logpdf_delta(
                        proposal, P_n, Mu_n, Sq_n)
                lq_fwd = m.truncnorm_logpdf(proposal, mu, var)
                lq_rev = m.truncnorm_logpdf(P_n, mu_r, var_r)
                log_ratio = (jnp.sum(lp_core, axis=1) + lprior_delta
                             + lq_rev - lq_fwd)
                # prior-draw fallback proposal (all-zero E row): target and
                # proposal coincide → always accept
                log_ratio = jnp.where(inactive_E, 0.0, log_ratio)
            else:
                # reference kernel: normal-model likelihoods stand in for the
                # proposal densities ("priors cancel"), with sigmasq
                # pmax(Mhat_prop,1)/pmax(Mhat,1) (sample_Pn.R:209-239); all
                # four row-sums fused into the same single pass.
                vs_old = jnp.maximum(Mhat_prop, 1.0)
                vs_new = jnp.maximum(Mhat, 1.0)
                r_old = data - Mhat
                r_new = data - Mhat_prop
                log_ratio = jnp.sum(
                    lp_core
                    + (-0.5 * r_old * r_old / vs_old - 0.5 * jnp.log(vs_old))
                    - (-0.5 * r_new * r_new / vs_new - 0.5 * jnp.log(vs_new)),
                    axis=1,
                )
            ratio_raw = jnp.minimum(jnp.exp(log_ratio), 1.0)
            nan_mask = jnp.isnan(ratio_raw)
            n_nan = n_nan + jnp.sum(nan_mask.astype(jnp.float32))
            ratio = jnp.where(nan_mask, 0.0, ratio_raw)
            u = u_col[2]
            if accept_all is True:
                take = jnp.ones((K,), bool)
                ratio_rec = jnp.ones((K,))
            elif accept_all is False:
                take = u < ratio
                ratio_rec = ratio
            else:
                take = jnp.where(accept_all, jnp.ones((K,), bool), u < ratio)
                ratio_rec = jnp.where(accept_all, jnp.ones((K,)), ratio)
            mh_col = jnp.where(take, proposal, P_n)
            new_col = jnp.where(A_n == 0, prior_col, mh_col)
            acc_P = acc_P.at[:, n].set(jnp.where(A_n == 0, acc_P[:, n], ratio_rec))
        else:
            new_col = jnp.where(A_n == 0, prior_col, proposal)

        Mhat = Mhat + A_n * jnp.outer(new_col - P_n, E_n)
        P = jax.lax.dynamic_update_index_in_dim(P, new_col, n, axis=1)
        return (P, Mhat, acc_P, n_nan)

    P, Mhat, acc_P, n_nan = jax.lax.fori_loop(
        0, N, body, (params["P"], Mhat, acc_P, jnp.float32(0.0)))
    return P, Mhat, acc_P, n_nan


# ---------------------------------------------------------------------------
# sequential E sweep — maps C8, exact mirror over rows/G (sample_En.R)
# ---------------------------------------------------------------------------


def sweep_E(spec: ModelSpec, data, params: dict, prior: dict, Mhat, acc_E, key, accept_all):
    P, A = params["P"], params["A"]
    sigmasq = params.get("sigmasq")
    K, N, G = spec.K, spec.N, spec.G
    k_prior_all, k_u_all = jax.random.split(key)
    mh = spec.likelihood == "poisson" and spec.MH
    E_prior = _prior_draw_E(spec, prior, k_prior_all)
    # one uniform launch for all rows' proposal pairs + acceptance draws
    # (mirrors sweep_P)
    U = jax.random.uniform(k_u_all, (3, N, G), jnp.float32,
                           minval=jnp.float32(1.2e-38))

    def body(n, carry):
        E, Mhat, acc_E, n_nan = carry
        u_row = jax.lax.dynamic_index_in_dim(U, n, axis=1, keepdims=False)
        A_n = jax.lax.dynamic_index_in_dim(A, n, keepdims=False)
        P_n = jax.lax.dynamic_index_in_dim(P, n, axis=1, keepdims=False)  # (K,)
        E_n = jax.lax.dynamic_index_in_dim(E, n, axis=0, keepdims=False)  # (G,)

        if mh:
            sig_mat = jnp.maximum(Mhat, m.MHAT_FLOOR)
        else:
            sig_mat = jnp.broadcast_to(sigmasq[None, :], (K, G))
        Mhat_no_n = Mhat - A_n * jnp.outer(P_n, E_n)
        # shared-input reduces instead of dots — see the P-sweep note
        resid = data - Mhat_no_n
        inv_sig = 1.0 / sig_mat
        mu1 = jnp.sum(resid * inv_sig * P_n[:, None], axis=0)  # (G,)
        den = A_n * jnp.sum(inv_sig * (P_n * P_n)[:, None], axis=0)  # (G,)
        if spec.prior == "exponential":
            Lam_n = jax.lax.dynamic_index_in_dim(prior["Lambda_e"], n, axis=0, keepdims=False)
            den_s = jnp.maximum(den, _EPS)
            mu = (mu1 - Lam_n) / den_s
            var = 1.0 / den_s
        else:
            Mu_n = jax.lax.dynamic_index_in_dim(prior["Mu_e"], n, axis=0, keepdims=False)
            Sq_n = jax.lax.dynamic_index_in_dim(prior["Sigmasq_e"], n, axis=0, keepdims=False)
            den2 = den + 1.0 / Sq_n
            mu = (mu1 + Mu_n / Sq_n) / den2
            var = 1.0 / den2
        cond_draw = dist.truncnorm_nonneg_from_u(u_row[0], u_row[1], mu, var)

        prior_row = jax.lax.dynamic_index_in_dim(E_prior, n, axis=0, keepdims=False)
        inactive_P = jnp.sum(P_n * P_n) <= 0.0
        proposal = jnp.where(inactive_P, prior_row, cond_draw)

        if mh:
            # mirror of the P-sweep MH correction over columns (MH_En_poisson)
            Mhat_prop = Mhat + A_n * jnp.outer(P_n, proposal - E_n)
            lam_old = jnp.maximum(Mhat, m.MHAT_FLOOR)
            lam_new = jnp.maximum(Mhat_prop, m.MHAT_FLOOR)
            d_lam = lam_new - lam_old
            lp_core = data * jnp.log1p(d_lam / lam_old) - d_lam
            if spec.exact_mh:
                sig_r = jnp.maximum(Mhat_prop, m.MHAT_FLOOR)
                inv_sig_r = 1.0 / sig_r
                mu1_r = jnp.sum(resid * inv_sig_r * P_n[:, None], axis=0)
                den_r = A_n * jnp.sum(inv_sig_r * (P_n * P_n)[:, None], axis=0)
                if spec.prior == "exponential":
                    den_rs = jnp.maximum(den_r, _EPS)
                    mu_r = (mu1_r - Lam_n) / den_rs
                    var_r = 1.0 / den_rs
                    lprior_delta = -Lam_n * (proposal - E_n)
                else:
                    den_r2 = den_r + 1.0 / Sq_n
                    mu_r = (mu1_r + Mu_n / Sq_n) / den_r2
                    var_r = 1.0 / den_r2
                    lprior_delta = m.truncnorm_logpdf_delta(
                        proposal, E_n, Mu_n, Sq_n)
                lq_fwd = m.truncnorm_logpdf(proposal, mu, var)
                lq_rev = m.truncnorm_logpdf(E_n, mu_r, var_r)
                log_ratio = (jnp.sum(lp_core, axis=0) + lprior_delta
                             + lq_rev - lq_fwd)
                log_ratio = jnp.where(inactive_P, 0.0, log_ratio)
            else:
                vs_old = jnp.maximum(Mhat_prop, 1.0)
                vs_new = jnp.maximum(Mhat, 1.0)
                r_old = data - Mhat
                r_new = data - Mhat_prop
                log_ratio = jnp.sum(
                    lp_core
                    + (-0.5 * r_old * r_old / vs_old - 0.5 * jnp.log(vs_old))
                    - (-0.5 * r_new * r_new / vs_new - 0.5 * jnp.log(vs_new)),
                    axis=0,
                )
            ratio_raw = jnp.minimum(jnp.exp(log_ratio), 1.0)
            nan_mask = jnp.isnan(ratio_raw)
            n_nan = n_nan + jnp.sum(nan_mask.astype(jnp.float32))
            ratio = jnp.where(nan_mask, 0.0, ratio_raw)
            u = u_row[2]
            if accept_all is True:
                take = jnp.ones((G,), bool)
                ratio_rec = jnp.ones((G,))
            elif accept_all is False:
                take = u < ratio
                ratio_rec = ratio
            else:
                take = jnp.where(accept_all, jnp.ones((G,), bool), u < ratio)
                ratio_rec = jnp.where(accept_all, jnp.ones((G,)), ratio)
            mh_row = jnp.where(take, proposal, E_n)
            new_row = jnp.where(A_n == 0, prior_row, mh_row)
            acc_E = acc_E.at[n, :].set(jnp.where(A_n == 0, acc_E[n, :], ratio_rec))
        else:
            new_row = jnp.where(A_n == 0, prior_row, proposal)

        Mhat = Mhat + A_n * jnp.outer(P_n, new_row - E_n)
        E = jax.lax.dynamic_update_index_in_dim(E, new_row, n, axis=0)
        return (E, Mhat, acc_E, n_nan)

    E, Mhat, acc_E, n_nan = jax.lax.fori_loop(
        0, N, body, (params["E"], Mhat, acc_E, jnp.float32(0.0)))
    return E, Mhat, acc_E, n_nan


# ---------------------------------------------------------------------------
# streaming sweeps (large-G ensembles): Mhat recomputed per kernel block,
# never held in device memory
# ---------------------------------------------------------------------------


def stream_sweep_P(spec: ModelSpec, data, params: dict, prior: dict, acc_P,
                   key, accept_all):
    """sweep_P without a device-resident Mhat (poisson + exact-MH only).

    Per column, two streaming Pallas kernels (ops/pallas_stream_sweeps)
    recompute each block's Mhat tile from P and the E tile and emit only the
    forward/reverse conditional reductions, so the per-column memory traffic
    is two reads of data + E instead of the XLA path's ~7 (C, K, G) streams
    (sig, Mhat_no_n, Mhat_prop, the rank-1 update...). The sampling math —
    conditional mean/variance, exact TruncNormal Hastings correction
    (MH_Pn_poisson, sample_Pn.R:199-248), clamped-NaN fallback — is
    identical to sweep_P's exact-MH branch; same key-split structure, so
    the two paths draw matched randomness (pinned by
    tests/test_stream_sweeps.py). Returns (P, acc_P, n_nan) — no Mhat.
    """
    from ..ops import pallas_stream_sweeps as S

    E, A = params["E"], params["A"]
    K, N = spec.K, spec.N
    k_prior_all, k_u_all = jax.random.split(key)
    P_prior = _prior_draw_P(spec, prior, k_prior_all)
    U = jax.random.uniform(k_u_all, (3, N, K), jnp.float32,
                           minval=jnp.float32(1.2e-38))

    def body(n, carry):
        P, acc_P, n_nan = carry
        u_col = jax.lax.dynamic_index_in_dim(U, n, axis=1, keepdims=False)
        A_n = jax.lax.dynamic_index_in_dim(A, n, keepdims=False)
        E_n = jax.lax.dynamic_index_in_dim(E, n, axis=0, keepdims=False)
        P_n = jax.lax.dynamic_index_in_dim(P, n, axis=1, keepdims=False)
        PA = P * A[None, :]

        mu1, den_raw = S.pcol_stats(data, E, PA, E_n, A_n * P_n)
        den = A_n * den_raw
        if spec.prior == "exponential":
            Lam_n = jax.lax.dynamic_index_in_dim(
                prior["Lambda_p"], n, axis=1, keepdims=False)
            den_s = jnp.maximum(den, _EPS)
            mu = (mu1 - Lam_n) / den_s
            var = 1.0 / den_s
        else:  # truncnormal
            Mu_n = jax.lax.dynamic_index_in_dim(
                prior["Mu_p"], n, axis=1, keepdims=False)
            Sq_n = jax.lax.dynamic_index_in_dim(
                prior["Sigmasq_p"], n, axis=1, keepdims=False)
            den2 = den + 1.0 / Sq_n
            mu = (mu1 + Mu_n / Sq_n) / den2
            var = 1.0 / den2
        cond_draw = dist.truncnorm_nonneg_from_u(u_col[0], u_col[1], mu, var)

        prior_col = jax.lax.dynamic_index_in_dim(
            P_prior, n, axis=1, keepdims=False)
        inactive_E = jnp.sum(E_n * E_n) <= 0.0
        proposal = jnp.where(inactive_E, prior_col, cond_draw)

        lp_row, mu1_r, den_raw_r = S.pcol_accept(
            data, E, PA, E_n, A_n * P_n, A_n * proposal)
        den_r = A_n * den_raw_r
        if spec.prior == "exponential":
            den_rs = jnp.maximum(den_r, _EPS)
            mu_r = (mu1_r - Lam_n) / den_rs
            var_r = 1.0 / den_rs
            lprior_delta = -Lam_n * (proposal - P_n)
        else:
            den_r2 = den_r + 1.0 / Sq_n
            mu_r = (mu1_r + Mu_n / Sq_n) / den_r2
            var_r = 1.0 / den_r2
            lprior_delta = m.truncnorm_logpdf_delta(
                proposal, P_n, Mu_n, Sq_n)
        lq_fwd = m.truncnorm_logpdf(proposal, mu, var)
        lq_rev = m.truncnorm_logpdf(P_n, mu_r, var_r)
        log_ratio = lp_row + lprior_delta + lq_rev - lq_fwd
        log_ratio = jnp.where(inactive_E, 0.0, log_ratio)

        ratio_raw = jnp.minimum(jnp.exp(log_ratio), 1.0)
        nan_mask = jnp.isnan(ratio_raw)
        n_nan = n_nan + jnp.sum(nan_mask.astype(jnp.float32))
        ratio = jnp.where(nan_mask, 0.0, ratio_raw)
        u = u_col[2]
        if accept_all is True:
            take = jnp.ones((K,), bool)
            ratio_rec = jnp.ones((K,))
        elif accept_all is False:
            take = u < ratio
            ratio_rec = ratio
        else:
            take = jnp.where(accept_all, jnp.ones((K,), bool), u < ratio)
            ratio_rec = jnp.where(accept_all, jnp.ones((K,)), ratio)
        mh_col = jnp.where(take, proposal, P_n)
        new_col = jnp.where(A_n == 0, prior_col, mh_col)
        acc_P = acc_P.at[:, n].set(
            jnp.where(A_n == 0, acc_P[:, n], ratio_rec))
        P = jax.lax.dynamic_update_index_in_dim(P, new_col, n, axis=1)
        return (P, acc_P, n_nan)

    P, acc_P, n_nan = jax.lax.fori_loop(
        0, N, body, (params["P"], acc_P, jnp.float32(0.0)))
    return P, acc_P, n_nan


def stream_sweep_E(spec: ModelSpec, data, params: dict, prior: dict, acc_E,
                   key, accept_all):
    """Streaming mirror of sweep_E over rows (MH_En_poisson); see
    stream_sweep_P. Returns (E, acc_E, n_nan)."""
    from ..ops import pallas_stream_sweeps as S

    P, A = params["P"], params["A"]
    N, G = spec.N, spec.G
    k_prior_all, k_u_all = jax.random.split(key)
    E_prior = _prior_draw_E(spec, prior, k_prior_all)
    U = jax.random.uniform(k_u_all, (3, N, G), jnp.float32,
                           minval=jnp.float32(1.2e-38))

    def body(n, carry):
        E, acc_E, n_nan = carry
        u_row = jax.lax.dynamic_index_in_dim(U, n, axis=1, keepdims=False)
        A_n = jax.lax.dynamic_index_in_dim(A, n, keepdims=False)
        P_n = jax.lax.dynamic_index_in_dim(P, n, axis=1, keepdims=False)
        E_n = jax.lax.dynamic_index_in_dim(E, n, axis=0, keepdims=False)
        PA = P * A[None, :]

        mu1, den_raw = S.erow_stats(data, E, PA, A_n * E_n, P_n)
        den = A_n * den_raw
        if spec.prior == "exponential":
            Lam_n = jax.lax.dynamic_index_in_dim(
                prior["Lambda_e"], n, axis=0, keepdims=False)
            den_s = jnp.maximum(den, _EPS)
            mu = (mu1 - Lam_n) / den_s
            var = 1.0 / den_s
        else:
            Mu_n = jax.lax.dynamic_index_in_dim(
                prior["Mu_e"], n, axis=0, keepdims=False)
            Sq_n = jax.lax.dynamic_index_in_dim(
                prior["Sigmasq_e"], n, axis=0, keepdims=False)
            den2 = den + 1.0 / Sq_n
            mu = (mu1 + Mu_n / Sq_n) / den2
            var = 1.0 / den2
        cond_draw = dist.truncnorm_nonneg_from_u(u_row[0], u_row[1], mu, var)

        prior_row = jax.lax.dynamic_index_in_dim(
            E_prior, n, axis=0, keepdims=False)
        inactive_P = jnp.sum(P_n * P_n) <= 0.0
        proposal = jnp.where(inactive_P, prior_row, cond_draw)

        lp_col, mu1_r, den_raw_r = S.erow_accept(
            data, E, PA, A_n * E_n, P_n, A_n * proposal)
        den_r = A_n * den_raw_r
        if spec.prior == "exponential":
            den_rs = jnp.maximum(den_r, _EPS)
            mu_r = (mu1_r - Lam_n) / den_rs
            var_r = 1.0 / den_rs
            lprior_delta = -Lam_n * (proposal - E_n)
        else:
            den_r2 = den_r + 1.0 / Sq_n
            mu_r = (mu1_r + Mu_n / Sq_n) / den_r2
            var_r = 1.0 / den_r2
            lprior_delta = m.truncnorm_logpdf_delta(
                proposal, E_n, Mu_n, Sq_n)
        lq_fwd = m.truncnorm_logpdf(proposal, mu, var)
        lq_rev = m.truncnorm_logpdf(E_n, mu_r, var_r)
        log_ratio = lp_col + lprior_delta + lq_rev - lq_fwd
        log_ratio = jnp.where(inactive_P, 0.0, log_ratio)

        ratio_raw = jnp.minimum(jnp.exp(log_ratio), 1.0)
        nan_mask = jnp.isnan(ratio_raw)
        n_nan = n_nan + jnp.sum(nan_mask.astype(jnp.float32))
        ratio = jnp.where(nan_mask, 0.0, ratio_raw)
        u = u_row[2]
        if accept_all is True:
            take = jnp.ones((G,), bool)
            ratio_rec = jnp.ones((G,))
        elif accept_all is False:
            take = u < ratio
            ratio_rec = ratio
        else:
            take = jnp.where(accept_all, jnp.ones((G,), bool), u < ratio)
            ratio_rec = jnp.where(accept_all, jnp.ones((G,)), ratio)
        mh_row = jnp.where(take, proposal, E_n)
        new_row = jnp.where(A_n == 0, prior_row, mh_row)
        acc_E = acc_E.at[n, :].set(
            jnp.where(A_n == 0, acc_E[n, :], ratio_rec))
        E = jax.lax.dynamic_update_index_in_dim(E, new_row, n, axis=0)
        return (E, acc_E, n_nan)

    E, acc_E, n_nan = jax.lax.fori_loop(
        0, N, body, (params["E"], acc_E, jnp.float32(0.0)))
    return E, acc_E, n_nan


# ---------------------------------------------------------------------------
# conjugate Poisson-Gibbs P/E draws (vectorized over the whole matrix)
# ---------------------------------------------------------------------------


def sample_P_poisson_gibbs(spec: ModelSpec, prior: dict, params: dict, key):
    """Conjugate Gamma draw of all of P given latent-count sums.

    Parity: sample_Pn_poisson (sample_Pn.R:98-120); exactly equivalent to the
    reference's sequential n-loop because the conditional factorizes given Z.
    When A_n = 0 the Z-sums are zero and the formula reduces to the prior
    draw, matching the sample_Pn dispatch (sample_Pn.R:12-29).
    """
    A, E, Zsum_g = params["A"], params["E"], params["Zsum_g"]
    rate_add = (A * jnp.sum(E, axis=1))[None, :]  # (1, N)
    if spec.prior == "gamma":
        shape = prior["Alpha_p"] + Zsum_g
        rate = prior["Beta_p"] + rate_add
    else:  # exponential
        shape = 1.0 + Zsum_g
        rate = prior["Lambda_p"] + rate_add
    return dist.gamma(key, shape, rate)


def sample_E_poisson_gibbs(spec: ModelSpec, prior: dict, params: dict, P_new, key):
    """Mirror for E (sample_En.R:97-119); uses the freshly updated P."""
    A, Zsum_k = params["A"], params["Zsum_k"]
    rate_add = (A * jnp.sum(P_new, axis=0))[:, None]  # (N, 1)
    if spec.prior == "gamma":
        shape = prior["Alpha_e"] + Zsum_k
        rate = prior["Beta_e"] + rate_add
    else:
        shape = 1.0 + Zsum_k
        rate = prior["Lambda_e"] + rate_add
    return dist.gamma(key, shape, rate)


# ---------------------------------------------------------------------------
# rank learning: R and the A sweep (maps C9)
# ---------------------------------------------------------------------------


def prior_prob_1(R, N, clip_val=0.4):
    """clip(R/N, 0.4/N, 1-0.4/N) (compute_prior_prob_1, sample_params.R:178-187)."""
    p = R / N
    return jnp.clip(p, clip_val / N, 1.0 - clip_val / N)


def sample_R(spec: ModelSpec, A, temperature, key):
    """Discrete posterior over expected rank 0..N (sample_R, :217-241)."""
    N = spec.N
    sumA = jnp.sum(A)
    r = jnp.arange(N + 1, dtype=jnp.float32)
    p1 = prior_prob_1(r, N)
    loglik = sumA * jnp.log(p1) + (N - sumA) * jnp.log(1.0 - p1)
    return jax.random.categorical(key, temperature * loglik).astype(jnp.int32)


def sweep_A(spec: ModelSpec, data, params: dict, R, Mhat, temperature, key):
    """Sequential Bernoulli updates of the inclusion vector A.

    Parity: sample_An (sample_params.R:101-166). The two loglik evaluations
    per n collapse into one fused delta pass: only loglik(A_n=1)-loglik(A_n=0)
    enters the posterior odds. SBFI subtracts the BIC-penalty delta
    (G+K)·log(G)/2 (:118-126); BFI uses raw logliks (:127-130); both tempered.
    Returns (A, Mhat, n_nan) where n_nan counts NaN-overflow fallbacks.
    """
    P, E = params["P"], params["E"]
    sigmasq = params.get("sigmasq")
    K, N, G = spec.K, spec.N, spec.G
    keys = jax.random.split(key, N)
    p1 = prior_prob_1(R.astype(jnp.float32), N)
    logit_p1 = jnp.log(p1) - jnp.log1p(-p1)
    sbfi_pen = (G + K) * jnp.log(jnp.float32(G)) / 2.0

    def body(n, carry):
        A, Mhat, n_nan = carry
        A_n = jax.lax.dynamic_index_in_dim(A, n, keepdims=False)
        P_n = jax.lax.dynamic_index_in_dim(P, n, axis=1, keepdims=False)
        E_n = jax.lax.dynamic_index_in_dim(E, n, axis=0, keepdims=False)
        contrib = jnp.outer(P_n, E_n)
        Mhat_off = Mhat - A_n * contrib
        if spec.likelihood == "poisson":
            lam_on = jnp.maximum(Mhat_off + contrib, m.MHAT_FLOOR)
            lam_off = jnp.maximum(Mhat_off, m.MHAT_FLOOR)
            d_lam = lam_on - lam_off
            delta = jnp.sum(data * jnp.log1p(d_lam / lam_off) - d_lam)
        else:
            r_on = data - (Mhat_off + contrib)
            r_off = data - Mhat_off
            delta = jnp.sum((r_off * r_off - r_on * r_on) / (2.0 * sigmasq[None, :]))
        if spec.rank_method == "SBFI":
            delta = delta - sbfi_pen
        log_odds = logit_p1 + temperature * delta
        p = jax.nn.sigmoid(log_odds)
        # overflow fallback: p = 1/2, counted (the analog of the reference's
        # logged NA ladder, sample_params.R:136-162)
        is_nan = jnp.isnan(p)
        n_nan = n_nan + is_nan.astype(jnp.float32)
        p = jnp.where(is_nan, 0.5, p)
        a_new = jax.random.bernoulli(keys[n], p).astype(jnp.float32)
        Mhat = Mhat_off + a_new * contrib
        A = A.at[n].set(a_new)
        return (A, Mhat, n_nan)

    A, Mhat, n_nan = jax.lax.fori_loop(
        0, N, body, (params["A"], Mhat, jnp.float32(0.0)))
    return A, Mhat, n_nan


def stream_sweep_A(spec: ModelSpec, data, params: dict, R, temperature, key):
    """sweep_A without a device-resident Mhat (poisson stream path): the per
    -column loglik delta comes from one streaming kernel
    (ops/pallas_stream_sweeps.acol_delta); everything else — the
    SBFI/BFI penalty, tempering, the NaN fallback, the Bernoulli draw and
    key structure — mirrors sweep_A exactly. Returns (A, n_nan)."""
    from ..ops import pallas_stream_sweeps as S

    P, E = params["P"], params["E"]
    K, N, G = spec.K, spec.N, spec.G
    keys = jax.random.split(key, N)
    p1 = prior_prob_1(R.astype(jnp.float32), N)
    logit_p1 = jnp.log(p1) - jnp.log1p(-p1)
    sbfi_pen = (G + K) * jnp.log(jnp.float32(G)) / 2.0

    def body(n, carry):
        A, n_nan = carry
        A_n = jax.lax.dynamic_index_in_dim(A, n, keepdims=False)
        P_n = jax.lax.dynamic_index_in_dim(P, n, axis=1, keepdims=False)
        E_n = jax.lax.dynamic_index_in_dim(E, n, axis=0, keepdims=False)
        delta = S.acol_delta(data, E, P * A[None, :], E_n, P_n, A_n)
        if spec.rank_method == "SBFI":
            delta = delta - sbfi_pen
        log_odds = logit_p1 + temperature * delta
        p = jax.nn.sigmoid(log_odds)
        is_nan = jnp.isnan(p)
        n_nan = n_nan + is_nan.astype(jnp.float32)
        p = jnp.where(is_nan, 0.5, p)
        a_new = jax.random.bernoulli(keys[n], p).astype(jnp.float32)
        A = A.at[n].set(a_new)
        return (A, n_nan)

    A, n_nan = jax.lax.fori_loop(
        0, N, body, (params["A"], jnp.float32(0.0)))
    return A, n_nan


# ---------------------------------------------------------------------------
# sigmasq (normal likelihood) — maps C11
# ---------------------------------------------------------------------------


def sample_sigmasq(spec: ModelSpec, data, prior: dict, Mhat, key):
    """sigmasq_g ~ InvGamma(Alpha+K/2, Beta+½Σ resid²) (sample_params.R:275-286)."""
    resid = data - Mhat
    rss = jnp.sum(resid * resid, axis=0)  # (G,)
    return dist.inv_gamma(
        key, prior["Alpha_sig"] + spec.K / 2.0, prior["Beta_sig"] + 0.5 * rss
    )


# ---------------------------------------------------------------------------
# latent count allocation — maps C10
# ---------------------------------------------------------------------------


def sample_Z_sums(spec: ModelSpec, data, params: dict, key):
    return allocate_counts(key, data, params["P"], params["A"], params["E"])
