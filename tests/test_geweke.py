"""Geweke 'getting it right' joint-distribution tests.

Validates every Gibbs transition jointly (SURVEY.md §4 implication): if the
sampler's transition kernel leaves p(params | data) invariant, then the
successive-conditional chain — params-transition followed by re-drawing the
data from the likelihood — started from an exact prior draw stays exactly in
the joint p(params, data) at every step. Its marginal statistics of (P, E)
must match plain prior draws.

Design: C independent chains vmapped on device, T steps each; per-chain means
are (nearly) iid units, giving a clean z-test against the marginal-draw mean.
A systematic error in any conditional (wrong rate, swapped shape, biased
truncated-normal, broken slice sampler...) shifts these statistics by many
standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesnmf_tpu.config import ModelSpec
from bayesnmf_tpu.models import gibbs

K, N, G = 3, 2, 4
C = 64     # chains
T = 250    # transitions per chain


def fixed_hp(spec):
    """Constant hyperpriors (cannot depend on data in a Geweke test)."""
    if spec.prior == "truncnormal":
        hp = {"m_p": 1.0, "s_p": 0.5, "a_p": 4.0, "b_p": 3.0,
              "m_e": 1.0, "s_e": 0.5, "a_e": 4.0, "b_e": 3.0}
    elif spec.prior == "exponential":
        hp = {"a_p": 5.0, "b_p": 5.0, "a_e": 5.0, "b_e": 5.0}
    else:
        hp = {"a_p": 6.0, "b_p": 3.0, "c_p": 6.0, "d_p": 3.0,
              "a_e": 6.0, "b_e": 3.0, "c_e": 6.0, "d_e": 3.0}
    if spec.likelihood == "normal":
        hp |= {"alpha": 4.0, "beta": 3.0}
    return hp


def redraw_data(spec, key, params):
    """Exact draw of the data layer given params.

    For the Z-augmented Poisson-Gibbs path the latent counts are part of the
    joint: regenerate Z ~ Poisson(P_kn A_n E_ng) elementwise and set
    M = Σ_n Z (keeping the M = ΣZ constraint consistent); the marginal of M
    is the same Poisson(Mhat). Returns (data, params) with refreshed Z-sums.
    """
    from bayesnmf_tpu.ops import math as m

    if spec.likelihood == "poisson":
        if spec.needs_Z:
            lam = jnp.einsum("kn,n,ng->kng", params["P"], params["A"],
                             params["E"])
            Z = jax.random.poisson(key, jnp.maximum(lam, 1e-12)).astype(
                jnp.float32)
            params = dict(params)
            params["Zsum_g"] = jnp.sum(Z, axis=2)
            params["Zsum_k"] = jnp.sum(Z, axis=0)
            return jnp.sum(Z, axis=1), params
        Mh = m.mhat(params["P"], params["A"], params["E"])
        return (jax.random.poisson(key, jnp.maximum(Mh, 1e-6)).astype(
            jnp.float32), params)
    Mh = m.mhat(params["P"], params["A"], params["E"])
    noise = jax.random.normal(key, Mh.shape) * jnp.sqrt(
        params["sigmasq"][None, :])
    return Mh + noise, params


def stats_of(params, learning=False):
    P, E = params["P"], params["E"]
    s = [
        jnp.mean(P), jnp.mean(P * P), jnp.mean(E), jnp.mean(E * E),
        jnp.mean(P) * jnp.mean(E),
    ]
    if learning:
        # A and R are part of the joint only when rank learning (otherwise
        # they are the constants 1 and N, making the z-score 0/0)
        s += [jnp.mean(params["A"]), params["R"].astype(jnp.float32)]
    return jnp.stack(s)


def run_successive(spec, hp, seed=0, n_chains=None, n_steps=None):
    """n_chains x n_steps successive-conditional transitions; returns
    per-chain mean statistics (n_chains, n_stats). Dims come from ``spec``
    so the same harness runs at any shape. None defaults resolve to the
    module C/T at call time."""
    n_chains = C if n_chains is None else n_chains
    T = globals()["T"] if n_steps is None else n_steps

    def one_chain(key):
        k0, k1, kloop = jax.random.split(key, 3)
        # initial exact joint draw: params from prior via init_state
        d0, p0 = redraw_data(
            spec, k0,
            gibbs.init_state(spec, hp, jnp.zeros((spec.K, spec.G)),
                             k1)["params"])
        state = gibbs.init_state(spec, hp, d0, k1)
        state["params"] = {**state["params"],
                           **{k: v for k, v in p0.items()
                              if k in ("Zsum_g", "Zsum_k")}}

        def step(carry, kk):
            st, data = carry
            st, _ = gibbs.gibbs_step(spec, data, hp, st, jnp.float32(1.0),
                                     accept_all=False)
            data, new_params = redraw_data(spec, kk, st["params"])
            st = {**st, "params": new_params}
            return (st, data), stats_of(st["params"], spec.learning_rank)

        keys = jax.random.split(kloop, T)
        (_, _), s = jax.lax.scan(step, (state, d0), keys)
        return jnp.mean(s[T // 5:], axis=0)  # drop a short initial stretch

    keys = jax.random.split(jax.random.PRNGKey(seed), n_chains)
    return np.asarray(jax.jit(jax.vmap(one_chain))(keys))


def run_marginal(spec, hp, n=4096, seed=1):
    """Exact prior draws of (P, E) statistics (n, n_stats)."""

    def one(key):
        st = gibbs.init_state(spec, hp, jnp.zeros((spec.K, spec.G)), key)
        return stats_of(st["params"], spec.learning_rank)

    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return np.asarray(jax.jit(jax.vmap(one))(keys))


FAMILIES = [
    ("poisson", "exponential", False),
    ("poisson", "gamma", False),
    ("poisson", "truncnormal", True),
    ("poisson", "exponential", True),
    ("normal", "truncnormal", False),
    ("normal", "exponential", False),
]


def _geweke_z(spec, hp):
    succ = run_successive(spec, hp)
    marg = run_marginal(spec, hp)
    m_s = succ.mean(axis=0)
    se_s = succ.std(axis=0, ddof=1) / np.sqrt(succ.shape[0])
    m_m = marg.mean(axis=0)
    se_m = marg.std(axis=0, ddof=1) / np.sqrt(marg.shape[0])
    return (m_s - m_m) / np.sqrt(se_s**2 + se_m**2), m_s, m_m


@pytest.mark.slow
@pytest.mark.parametrize("likelihood,prior,mh", FAMILIES)
def test_geweke_joint(likelihood, prior, mh):
    spec = ModelSpec(K=K, N=N, G=G, likelihood=likelihood, prior=prior, MH=mh)
    hp = fixed_hp(spec)
    z, m_s, m_m = _geweke_z(spec, hp)
    # within-chain correlation inflates the naive SE of chain means only
    # mildly (each chain mean is ~iid); 6 sigma leaves essentially zero
    # false-positive rate while catching any systematic conditional bug.
    assert np.all(np.abs(z) < 6.0), (
        f"Geweke mismatch for {likelihood}/{prior}/MH={mh}: z={z}, "
        f"succ={m_s}, marg={m_m}")


@pytest.mark.slow
def test_geweke_joint_rank_learning_bfi():
    """Joint-distribution invariance of the rank-learning transitions
    (sample_R + the A sweep, sample_params.R:101-241).

    BFI only: the BFI A-update IS the exact Bernoulli full conditional
    (sample_params.R:127-130), so the joint test applies. SBFI deliberately
    penalizes the odds with BIC (:118-126) — a modified target, not the
    posterior of the generative model — so joint invariance does not hold
    for it by design (test_sbfi_penalty_biases_rank_down covers it).
    """
    spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson", prior="exponential",
                     MH=True, learning_rank=True, rank_method="BFI")
    hp = fixed_hp(spec)
    z, m_s, m_m = _geweke_z(spec, hp)
    assert np.all(np.abs(z) < 6.0), (
        f"Geweke mismatch for rank learning (BFI): "
        f"z={z}, succ={m_s}, marg={m_m}")


@pytest.mark.slow
def test_sbfi_penalty_biases_rank_down():
    """SBFI's BIC penalty must push the stationary mean of A *below* the BFI
    (exact-conditional) stationary mean in the successive-conditional chain —
    the direction-of-effect check for the penalty term (sample_params.R:118-126).
    """
    means = {}
    for rm in ("BFI", "SBFI"):
        spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson",
                         prior="exponential", MH=True, learning_rank=True,
                         rank_method=rm)
        succ = run_successive(spec, fixed_hp(spec))
        means[rm] = succ.mean(axis=0)[5]  # mean(A) statistic
    assert means["SBFI"] < means["BFI"], means


@pytest.mark.slow
@pytest.mark.parametrize("flag,expect_sign", [
    ("exact_mh", -1),                # reference MH ratio biases P/E DOWN
    ("exact_truncnorm_hypers", +1),  # reference conjugate hypers bias UP
])
def test_reference_kernels_fail_geweke(flag, expect_sign):
    """Adversarial demonstration of the reference kernels' stationary bias
    (the claim behind config.py's exact_* defaults).

    With ONE reference kernel substituted (the other exact), the Geweke
    successive-conditional chain drifts off the joint by many standard
    errors: the reference MH acceptance ratio (MH_Pn_poisson,
    sample_Pn.R:209-239, normal-model likelihood substituted for the
    truncated proposal density) biases the P/E marginals low (measured
    max|z| ≈ 7.4 at these seeds), while the reference conjugate
    Mu/Sigmasq hyper-updates (sample_priors.R:214-270, dropped
    Phi(mu/sigma) truncation normalizer) bias them high (max|z| ≈ 9.9).
    Notably the two biases act in opposite directions and partially cancel
    when combined (max|z| ≈ 2.2), which is presumably why the reference's
    end-to-end results look reasonable despite both kernels failing the
    joint test individually.
    """
    kw = {flag: False}
    spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson", prior="truncnormal",
                     MH=True, **kw)
    hp = fixed_hp(spec)
    z, m_s, m_m = _geweke_z(spec, hp)
    assert np.abs(z).max() > 6.0, (
        f"expected the reference kernel ({flag}=False) to FAIL the joint "
        f"test; z={z} — if this now passes, the exact_* default needs "
        "re-justification")
    # direction of the bias on the mean(P) statistic
    assert np.sign(z[0]) == expect_sign, (flag, z)


@pytest.mark.slow
def test_geweke_joint_stream_sweeps():
    """Joint invariance of the STREAMING sweep path (large-G ensembles,
    ops/pallas_stream_sweeps) — belt and braces on top of the draw-for-draw
    equivalence tests: the streamed reductions + streamed metrics leave the
    joint p(params, data) invariant on their own. Compiled on the GPU, in
    the Pallas interpreter elsewhere."""
    import contextlib

    from bayesnmf_tpu.ops import pallas_stream_sweeps as S

    spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson",
                     prior="truncnormal", MH=True, stream_sweeps=True)
    hp = fixed_hp(spec)
    on_gpu = jax.default_backend() == "gpu"
    with contextlib.nullcontext() if on_gpu else S.interpret_mode():
        z, m_s, m_m = _geweke_z(spec, hp)
    assert np.all(np.abs(z) < 6.0), (
        f"Geweke mismatch for stream_sweeps: z={z}, succ={m_s}, marg={m_m}")
