"""Vectorized on-device samplers for the Gibbs conditionals.

Device-side replacements for the reference's native RNG dependencies
(SURVEY.md §2.2): truncnorm (C) → ``truncnorm_nonneg``; invgamma →
``inv_gamma``; armspp (ARMS, C++) → ``slice_sample_logconcave`` (a vectorized
stepping-out + shrinkage slice sampler, an exact MCMC kernel for the same 1-D
conditionals); R stats rgamma/rexp/rbinom → jax.random counterparts.

All samplers take an explicit threefry key and are shaped for vmap over
chains; everything is f32 and jit-safe (static shapes, lax control flow only).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


_TINY = jnp.float32(1.1754944e-38)  # min normal f32


def _std_normal_lower_tail_from_u(u1, u2, alpha):
    """Z ~ N(0,1) | Z >= alpha from two pre-drawn uniforms in (0,1],
    elementwise, f32-robust.

    Two exact schemes selected per element:
      - tail-form inverse CDF  z = -ndtri(u * ndtr(-alpha))  (also covers the
        untruncated case: for alpha << 0 it degenerates to plain inverse-CDF
        sampling), valid until ndtr(-alpha) underflows (~alpha > 9 in f32);
      - deep tail (alpha > 8): the conditional law of alpha*(Z - alpha)
        converges to Exp(1) = -log(u2); the O(1/alpha^2) relative error
        (<1.6%) applies only to a region of prior mass ~ndtr(-8) ≈ 1e-15 and
        avoids a rejection loop inside the already-sequential Gibbs sweeps.

    Taking uniforms (not a key) lets callers feed MANY truncated-normal
    draws from ONE jax.random.uniform launch — RNG launches, not FLOPs,
    dominate small-problem Gibbs iterations.
    """
    tail = jax.scipy.special.ndtr(-alpha)
    v = jnp.maximum(u1 * tail, _TINY)
    z_icdf = jnp.maximum(-jax.scipy.special.ndtri(v), alpha)
    a_safe = jnp.maximum(alpha, 1.0)
    z_tail = a_safe - jnp.log(jnp.maximum(u2, _TINY)) / a_safe
    return jnp.where(alpha > 8.0, z_tail, z_icdf)


def _std_normal_lower_tail(key, alpha, shape):
    """Keyed wrapper over _std_normal_lower_tail_from_u (one uniform launch)."""
    u = jax.random.uniform(key, (2,) + shape, jnp.float32, minval=_TINY,
                           maxval=1.0)
    return _std_normal_lower_tail_from_u(u[0], u[1], alpha)


def truncnorm_nonneg_from_u(u1, u2, mu, sigmasq):
    """truncnorm_nonneg from two pre-drawn uniforms (see
    _std_normal_lower_tail_from_u for why)."""
    mu = jnp.asarray(mu, jnp.float32)
    sd = jnp.sqrt(jnp.asarray(sigmasq, jnp.float32))
    z = _std_normal_lower_tail_from_u(u1, u2, -mu / sd)
    return jnp.maximum(mu + sd * z, 0.0)


def truncnorm_nonneg(key, mu, sigmasq, shape=None):
    """Sample Normal(mu, sigmasq) truncated to [0, inf), elementwise.

    Replaces truncnorm::rtruncnorm(a=0, b=Inf) (sample_Pn.R:14-19 etc.),
    the single hottest RNG op of the MH path, fully vectorized on the VPU.
    """
    mu = jnp.asarray(mu, jnp.float32)
    sigmasq = jnp.asarray(sigmasq, jnp.float32)
    if shape is None:
        shape = jnp.broadcast_shapes(mu.shape, sigmasq.shape)
    sd = jnp.sqrt(sigmasq)
    alpha = jnp.broadcast_to(-mu / sd, shape)
    z = _std_normal_lower_tail(key, alpha, shape)
    x = mu + sd * z
    # Guard against -0.0 / tiny negative from float round-off.
    return jnp.maximum(x, 0.0)


def gamma(key, shape_param, rate, shape=None, unroll: int = 4):
    """Exact Gamma(shape, rate) draws (R parameterization: mean = shape/rate).

    Replaces ``jax.random.gamma`` on the hot paths: that implementation runs
    a rejection ``while_loop`` with fresh RNG bits per round (~29 µs per call
    plus a serialization barrier across the whole step on this backend; the
    conjugate Poisson-Gibbs iteration makes 4 such calls). Here ALL randomness
    comes from ONE uniform launch: Marsaglia-Tsang (2000) squeeze-free
    transformed rejection with ``unroll`` pre-drawn candidate rounds
    (acceptance > 95% for every a >= 1, so P(all rejected) < ~1e-5 per
    element) and an exact lax.while_loop fallback for the leftovers whose
    predicate is almost always false. a < 1 uses the standard boost
    Gamma(a) = Gamma(a+1) * U^(1/a). Exact sampler — same rejection test as
    the reference's stats::rgamma C implementation family.
    """
    shape_param = jnp.asarray(shape_param, jnp.float32)
    rate = jnp.asarray(rate, jnp.float32)
    if shape is None:
        shape = jnp.broadcast_shapes(shape_param.shape, rate.shape)
    a = jnp.broadcast_to(shape_param, shape)
    boost = a < 1.0
    a_eff = jnp.where(boost, a + 1.0, a)
    d = a_eff - 1.0 / 3.0
    c = 1.0 / jnp.sqrt(9.0 * d)

    u_all = jax.random.uniform(
        key, (2 * unroll + 1,) + shape, jnp.float32, minval=_TINY)

    def candidate(u_z, u_a):
        x = jax.scipy.special.ndtri(u_z)
        one_cx = 1.0 + c * x
        v = one_cx * one_cx * one_cx
        ok = (v > 0.0) & (
            jnp.log(u_a)
            < 0.5 * x * x + d - d * v + d * jnp.log(jnp.maximum(v, _TINY)))
        return d * v, ok

    g = jnp.full(shape, jnp.nan, jnp.float32)
    done = jnp.zeros(shape, bool)
    for r in range(unroll):
        gv, ok = candidate(u_all[2 * r], u_all[2 * r + 1])
        g = jnp.where(~done & ok, gv, g)
        done = done | ok

    # A non-finite or non-positive shape param makes the acceptance test
    # permanently false (NaN comparisons), which would spin the exact-fallback
    # while_loop forever and deadlock the whole device program. Mark such
    # elements done up front; they keep the NaN result, which the NA_events
    # observability downstream can see (a transient overflow in a sampled
    # shape like a + Alpha_p must surface as data, not a hang).
    done = done | ~jnp.isfinite(d) | (a <= 0.0)

    def cond(carry):
        done, _, _ = carry
        return ~jnp.all(done)

    def body(carry):
        done, g, kk = carry
        kk, k1 = jax.random.split(kk)
        uv = jax.random.uniform(k1, (2,) + shape, jnp.float32, minval=_TINY)
        gv, ok = candidate(uv[0], uv[1])
        g = jnp.where(~done & ok, gv, g)
        return done | ok, g, kk

    done, g, _ = jax.lax.while_loop(
        cond, body, (done, g, jax.random.fold_in(key, 11)))

    # boost for a < 1: multiply by U^(1/a) in log space (avoids 0^inf at
    # tiny a); exact, uses the last pre-drawn uniform
    g = g * jnp.where(
        boost,
        jnp.exp(jnp.log(u_all[-1]) / jnp.maximum(a, 1e-12)),
        1.0)
    return g / jnp.broadcast_to(rate, shape)


def inv_gamma(key, shape_param, rate, shape=None):
    """InvGamma(shape, rate) draws via 1/Gamma (replaces invgamma::rinvgamma)."""
    g = gamma(key, shape_param, rate, shape)
    return 1.0 / jnp.maximum(g, 1e-30)


def exponential(key, rate, shape=None):
    """Exponential(rate) draws (replaces stats::rexp)."""
    rate = jnp.asarray(rate, jnp.float32)
    if shape is None:
        shape = rate.shape
    e = jax.random.exponential(key, shape, jnp.float32)
    return e / jnp.broadcast_to(rate, shape)


def normal(key, mu, sigmasq, shape=None):
    mu = jnp.asarray(mu, jnp.float32)
    sigmasq = jnp.asarray(sigmasq, jnp.float32)
    if shape is None:
        shape = jnp.broadcast_shapes(mu.shape, sigmasq.shape)
    z = jax.random.normal(key, shape, jnp.float32)
    return mu + jnp.sqrt(sigmasq) * z


def bernoulli(key, p, shape=None):
    if shape is None:
        shape = jnp.asarray(p).shape
    return jax.random.bernoulli(key, p, shape)


@partial(
    jax.jit,
    static_argnames=("logpdf_fn", "lower", "upper", "n_steps", "n_shrink"),
)
def slice_sample_logconcave(
    key,
    x0: jnp.ndarray,
    logpdf_params: tuple,
    logpdf_fn,
    lower: float = 1e-3,
    upper: float = 1e4,
    width=1.0,
    n_steps: int = 8,
    n_shrink: int = 16,
):
    """One elementwise slice-sampling transition targeting independent 1-D
    densities ``logpdf_fn(x, *params)`` on (lower, upper).

    Replaces armspp::arms for the non-conjugate Gamma-prior shape conditionals
    (sample_priors.R:356-397). Slice sampling with stepping-out + shrinkage is
    an exact MCMC kernel (leaves the conditional invariant), fully vectorized
    over all K*N (or N*G) independent targets at once instead of the
    reference's per-scalar C++ calls.

    Args:
      x0: current values, any shape; logpdf_params broadcast against it.
      n_steps: stepping-out iterations (doubles the bracket each time).
      n_shrink: shrinkage iterations (halves the bracket towards x0).
    Returns new sample, same shape as x0.
    """
    x0 = jnp.asarray(x0, jnp.float32)
    k_h, k_l, k_r, k_u = jax.random.split(key, 4)

    logf = lambda x: logpdf_fn(jnp.clip(x, lower, upper), *logpdf_params)

    # vertical level: log y = log f(x0) - Exp(1)
    log_y = logf(x0) - jax.random.exponential(k_h, x0.shape, jnp.float32)

    # initial bracket of size `width` randomly positioned around x0
    # (width may be a per-element array matched to the local scale)
    width = jnp.broadcast_to(jnp.asarray(width, jnp.float32), x0.shape)
    u = jax.random.uniform(k_l, x0.shape, jnp.float32)
    L0 = jnp.maximum(x0 - width * u, lower)
    R0 = jnp.minimum(L0 + width, upper)

    # stepping out: expand each side while logf(edge) > log_y
    def step_out(carry, _):
        L, R, wL, wR = carry
        grow_L = logf(L) > log_y
        grow_R = logf(R) > log_y
        L = jnp.where(grow_L, jnp.maximum(L - wL, lower), L)
        R = jnp.where(grow_R, jnp.minimum(R + wR, upper), R)
        return (L, R, wL * 2.0, wR * 2.0), None

    (L, R, _, _), _ = jax.lax.scan(step_out, (L0, R0, width, width), None,
                                   length=n_steps)

    # shrinkage: sample uniformly in [L, R]; shrink towards x0 on rejection
    def shrink(carry, kk):
        L, R, x, accepted = carry
        u = jax.random.uniform(kk, x0.shape, jnp.float32)
        prop = L + u * (R - L)
        ok = logf(prop) > log_y
        newx = jnp.where(ok & ~accepted, prop, x)
        accepted2 = accepted | ok
        # shrink bracket for still-unaccepted lanes
        L = jnp.where(~accepted2 & (prop < x0), prop, L)
        R = jnp.where(~accepted2 & (prop >= x0), prop, R)
        return (L, R, newx, accepted2), None

    keys = jax.random.split(k_u, n_shrink)
    (_, _, x_new, accepted), _ = jax.lax.scan(
        shrink, (L, R, x0, jnp.zeros(x0.shape, bool)), keys
    )
    # lanes that never accepted keep x0 (valid MCMC: identity transition)
    return jnp.where(accepted, jnp.clip(x_new, lower, upper), x0)


def truncnorm_mu_cond_logpdf(mu, m_hp, s_hp, x, sq):
    """Unnormalized log-density of Mu | x, Sigmasq under the truncated-normal
    prior, INCLUDING the truncation normalizer the reference's conjugate
    update drops (sample_priors.R:214-236):

      N(mu; m_hp, s_hp) * N(x; mu, sq) / Phi(mu / sqrt(sq))
    """
    lead = -(mu - m_hp) ** 2 / (2.0 * s_hp) - (x - mu) ** 2 / (2.0 * sq)
    return lead - jax.scipy.special.log_ndtr(mu / jnp.sqrt(sq))


def truncnorm_logsigmasq_cond_logpdf(y, a_hp, b_hp, x, mu):
    """Unnormalized log-density of y = log(Sigmasq) | x, Mu under the
    truncated-normal prior (InvGamma(a,b) hyperprior), including the
    truncation normalizer and the log-space Jacobian:

      p(y) ∝ exp(-(a+1/2) y - (b + (x-mu)^2/2) e^{-y}) / Phi(mu e^{-y/2})
    """
    inv = jnp.exp(-y)
    lead = -(a_hp + 0.5) * y - (b_hp + 0.5 * (x - mu) ** 2) * inv
    return lead - jax.scipy.special.log_ndtr(mu * jnp.exp(-0.5 * y))


def gamma_shape_cond_logpdf(x, c, d, log_beta, log_param):
    """Unnormalized log-density of the Gamma-prior shape conditional.

    Parity: logpdf_prop in sample_Alpha_Pkn (sample_priors.R:357-363):
      (c-1) log x - d x + x log(beta) + (x-1) log(p) - lgamma(x)
    where p is the current P (or E) entry and beta its rate.
    """
    return (
        (c - 1.0) * jnp.log(x)
        - d * x
        + x * log_beta
        + (x - 1.0) * log_param
        - jax.lax.lgamma(x)
    )


# ---------------------------------------------------------------------------
# fast exact binomial — the latent-count allocation hot op
# ---------------------------------------------------------------------------


def _btrs_candidates(u, v, n, p, spq, b, a, c, vr, alpha, lpq, m, h):
    """One vectorized BTRS candidate round (Hörmann 1993, transformed
    rejection with squeeze): returns (k, accepted)."""
    us = 0.5 - jnp.abs(u)
    k = jnp.floor((2.0 * a / jnp.maximum(us, 1e-8) + b) * u + c)
    in_range = (k >= 0.0) & (k <= n)
    # squeeze: accept immediately in the bulk
    squeeze = (us >= 0.07) & (v <= vr)
    # full log acceptance test
    v2 = jnp.log(jnp.maximum(v, _TINY) * alpha
                 / (a / jnp.maximum(us * us, 1e-12) + b))
    t = (h - jax.lax.lgamma(k + 1.0) - jax.lax.lgamma(n - k + 1.0)
         + (k - m) * lpq)
    accept = in_range & (squeeze | (v2 <= t))
    return k, accept


def binomial_from_u(u_all, key_fb, n, p, unroll: int = 8,
                    inv_steps: int = 40):
    """Exact Binomial(n, p) from pre-drawn uniforms ``u_all`` of shape
    ``(2*unroll + 1,) + broadcast_shape`` (see ``binomial`` for the scheme;
    taking uniforms lets the allocation tree feed every level of conditional
    binomials from ONE ``jax.random.uniform`` launch). ``key_fb`` seeds the
    exact rejection fallback for the ~3e-8 of elements all ``unroll``
    pre-drawn BTRS rounds reject.
    """
    n = jnp.asarray(n, jnp.float32)
    p = jnp.asarray(p, jnp.float32)
    shape = jnp.broadcast_shapes(n.shape, p.shape)
    n = jnp.broadcast_to(n, shape)
    p = jnp.clip(jnp.broadcast_to(p, shape), 0.0, 1.0)

    flip = p > 0.5
    pp = jnp.where(flip, 1.0 - p, p)
    np_ = n * pp
    small = np_ <= 10.0

    # ---- inversion regime (sanitize: pp in (0, 0.5], n >= 0) -------------
    # Unrolled Python loop, NOT lax.scan: the body is a handful of
    # elementwise ops, so unrolling lets XLA fuse all ``inv_steps`` rounds
    # into one VPU kernel instead of paying per-step loop overhead.
    # inv_steps=40 is exact in f32: the largest CDF value an f32 uniform can
    # exceed is 1 - 2^-24, reached before x = 40 for every n·p' <= 10
    # (Poisson(10) tail: P(X > 32) ≈ 4e-9 < 2^-24).
    p_inv = jnp.where(small, pp, 0.01)
    n_inv = jnp.where(small, n, 1.0)
    u = u_all[0]
    ratio = p_inv / jnp.maximum(1.0 - p_inv, 1e-12)
    pmf = jnp.exp(n_inv * jnp.log1p(-p_inv))  # P(X=0)
    cdf = pmf
    x_inv = jnp.zeros(shape, jnp.float32)
    for j in range(inv_steps):
        x_inv = x_inv + (u > cdf).astype(jnp.float32)
        pmf = pmf * (n_inv - j) / (j + 1.0) * ratio
        cdf = cdf + pmf
    x_inv = jnp.minimum(x_inv, n_inv)

    # ---- BTRS regime (sanitize: np_ > 10) ---------------------------------
    p_b = jnp.where(small, 0.4, pp)
    n_b = jnp.where(small, 100.0, n)
    spq = jnp.sqrt(n_b * p_b * (1.0 - p_b))
    b = 1.15 + 2.53 * spq
    a = -0.0873 + 0.0248 * b + 0.01 * p_b
    c = n_b * p_b + 0.5
    vr = 0.92 - 4.2 / b
    alpha = (2.83 + 5.1 / b) * spq
    lpq = jnp.log(p_b / jnp.maximum(1.0 - p_b, 1e-12))
    m_ = jnp.floor((n_b + 1.0) * p_b)
    h = (jax.lax.lgamma(m_ + 1.0) + jax.lax.lgamma(n_b - m_ + 1.0))

    k_acc = jnp.zeros(shape, jnp.float32)
    done = jnp.zeros(shape, bool)
    for r in range(unroll):
        uu = u_all[1 + 2 * r] - 0.5
        vv = u_all[2 + 2 * r]
        k, ok = _btrs_candidates(uu, vv, n_b, p_b, spq, b, a, c, vr,
                                 alpha, lpq, m_, h)
        k_acc = jnp.where(~done & ok, k, k_acc)
        done = done | ok

    # exact fallback for the ~3e-8 leftovers: loop fresh candidate rounds
    def cond(carry):
        done, _, _ = carry
        return ~jnp.all(done)

    def body(carry):
        done, k_acc, kk = carry
        kk, k1 = jax.random.split(kk)
        uv = jax.random.uniform(k1, (2,) + shape, jnp.float32, minval=_TINY)
        k, ok = _btrs_candidates(uv[0] - 0.5, uv[1], n_b, p_b, spq, b, a, c,
                                 vr, alpha, lpq, m_, h)
        k_acc = jnp.where(~done & ok, k, k_acc)
        return done | ok, k_acc, kk

    # treat small-regime elements as already done so they never gate the
    # loop; same for non-finite n/p, whose acceptance test is permanently
    # false (NaN comparisons) and would deadlock the fallback loop — they
    # yield 0 from the inversion path, and upstream NaN state is already
    # surfaced via the NA_events metric
    done, k_acc, _ = jax.lax.while_loop(
        cond, body, (done | small | ~jnp.isfinite(np_), k_acc, key_fb))

    y = jnp.where(small, x_inv, k_acc)
    return jnp.where(flip, n - y, y)


def binomial(key, n, p, unroll: int = 8, inv_steps: int = 40):
    """Exact Binomial(n, p) sampler, elementwise over broadcast shapes.

    Replaces ``jax.random.binomial`` in the allocation hot loop: that
    implementation costs ~137 µs per (96,100) call on this backend (internal
    while_loop rounds with fresh RNG bits per round, both samplers evaluated)
    and degrades 34x on >2-D shapes. This one draws ALL randomness in ONE
    uniform launch and uses two exact regimes:

      - n·p' <= 10 (p' = min(p, 1-p)): CDF inversion by a fixed
        ``inv_steps`` fully-unrolled rounds — exact in f32 (see
        ``binomial_from_u``).
      - n·p' > 10: BTRS transformed rejection (Hörmann 1993) with
        ``unroll`` pre-drawn candidate rounds (acceptance ≥ ~0.86, so
        P(all rejected) < 3e-8 per element) and an exact lax.while_loop
        fallback for the leftovers — its predicate is almost always false,
        so it costs one predicate check per call.

    Symmetry: X = n - Binomial(n, 1-p) handles p > 1/2.
    """
    shape = jnp.broadcast_shapes(jnp.shape(n), jnp.shape(p))
    u_all = jax.random.uniform(
        key, (2 * unroll + 1,) + shape, jnp.float32, minval=_TINY)
    return binomial_from_u(u_all, jax.random.fold_in(key, 7), n, p,
                           unroll=unroll, inv_steps=inv_steps)
