"""The jitted Gibbs engine: one-step kernel, chunked scan runner, tempering.

The reference's hot loop (bayesNMF_sampler.R:265-408) becomes a pure function
``gibbs_step(state) -> state`` traced once per ModelSpec and scanned on device
in chunks of ``MAP_every`` iterations; the host only sees chunk boundaries
(metrics + sample windows), where convergence checks / logging / checkpointing
happen (SURVEY.md §7 design stance).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ModelSpec
from ..ops import math as m
from . import updates as U

# metrics-row layout (order matches the reference's sample_metrics columns,
# bayesNMF_sampler.R:190-207)
METRIC_NAMES = (
    "iter", "RMSE", "KL", "loglikelihood", "logposterior", "n_params", "BIC",
    "rank", "temp", "P_mean_acceptance_rate", "E_mean_acceptance_rate",
    # count of numeric-overflow fallbacks this iteration (MH ratios clamped
    # NaN→0 + A-sweep posteriors clamped NaN→1/2) — the observable analog of
    # the reference's logged NA-overflow ladder (sample_params.R:136-162)
    "NA_events",
)
N_METRICS = len(METRIC_NAMES)


# ---------------------------------------------------------------------------
# state construction
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("spec",))
def init_state(spec: ModelSpec, hp: dict, data, key, init_params=None,
               init_prior_params=None):
    """Build the initial sampler state: prior params from hyperpriors, params
    from priors, Z-sums/sigmasq from their conditionals, iteration 1 recorded.

    Parity: bayesNMF_sampler$initialize (bayesNMF_sampler.R:232-253).
    User-supplied ``init_params`` / ``init_prior_params`` entries override the
    corresponding draws (advanced.qmd:182-318 contract).

    Jitted as ONE program (the dict structures of the override args are part
    of the trace signature) rather than dispatched op by op.
    """
    k_prior, k_P, k_E, k_R, k_A, k_Z, k_s, k_next = jax.random.split(key, 8)
    prior = U.init_prior_params(spec, hp, k_prior)
    if init_prior_params:
        for name, v in init_prior_params.items():
            if name in ("alpha", "beta"):
                # scalar sigmasq-prior values broadcast to length G
                tgt = "Alpha_sig" if name == "alpha" else "Beta_sig"
                prior[tgt] = jnp.broadcast_to(
                    jnp.asarray(v, jnp.float32), (spec.G,))
            else:
                prior[name] = jnp.asarray(v, jnp.float32)

    params = {}
    params["P"] = U._prior_draw_P(spec, prior, k_P)
    params["E"] = U._prior_draw_E(spec, prior, k_E)
    if spec.learning_rank:
        # R ~ Uniform{0..N}, A_n ~ Bern(p1(R)) (sample_R/sample_An from_prior)
        params["R"] = jax.random.randint(k_R, (), 0, spec.N + 1, jnp.int32)
        p1 = U.prior_prob_1(params["R"].astype(jnp.float32), spec.N)
        params["A"] = jax.random.bernoulli(k_A, p1, (spec.N,)).astype(jnp.float32)
    else:
        params["R"] = jnp.asarray(spec.N, jnp.int32)
        params["A"] = jnp.ones((spec.N,), jnp.float32)
    if init_params:
        for name, v in init_params.items():
            params[name] = jnp.asarray(v, jnp.float32 if name != "R" else jnp.int32)

    Mh = m.mhat(params["P"], params["A"], params["E"])
    if spec.needs_Z:
        params["Zsum_g"], params["Zsum_k"] = U.sample_Z_sums(spec, data, params, k_Z)
    if spec.needs_sigmasq and "sigmasq" not in params:
        params["sigmasq"] = U.sample_sigmasq(spec, data, prior, Mh, k_s)

    state = {"params": params, "prior": prior, "key": k_next,
             "iter": jnp.asarray(1, jnp.int32)}
    if spec.MH:
        state["acc_P"] = jnp.ones((spec.K, spec.N), jnp.float32)
        state["acc_E"] = jnp.ones((spec.N, spec.G), jnp.float32)
    return state


# ---------------------------------------------------------------------------
# one Gibbs iteration
# ---------------------------------------------------------------------------


def gibbs_step(spec: ModelSpec, data, hp: dict, state: dict, temperature,
               accept_all, record: str = "basic", metric_consts=None):
    """One full Gibbs sweep; returns (new_state, sample_out).

    Update order matches run_gibbs_sampler + sample_params_
    (bayesNMF_sampler.R:275-285, sample_params.R:51-89):
    prior params → P sweep → E sweep → [R, A sweep] → [Z] → [sigmasq].

    ``record`` controls what the per-iteration sample_out carries:
      - 'metrics': the metrics row only (throughput mode — at huge G the
        stacked E history dominates device memory, and XLA
        dead-code-eliminates the unsampled tensors entirely);
      - 'basic': P/E/A + metrics (default);
      - 'full': additionally prior params, sigmasq, and MH acceptance
        matrices, matching the reference's record_sample
        (bayesNMF_sampler.R:651-672) which deep-copies every parameter each
        iteration.
    """
    key = state["key"]
    # split only the keys this spec consumes (threefry splits are ~12us for
    # 8 keys on-device — measurable at small problem sizes)
    n_extra = 2 * spec.learning_rank + spec.needs_Z + spec.needs_sigmasq
    ks_all = jax.random.split(key, 4 + n_extra)
    k_pp, k_P, k_E, k_next = ks_all[0], ks_all[1], ks_all[2], ks_all[3]
    _i = 4
    if spec.learning_rank:
        k_R, k_A = ks_all[_i], ks_all[_i + 1]
        _i += 2
    if spec.needs_Z:
        k_Z = ks_all[_i]
        _i += 1
    if spec.needs_sigmasq:
        k_s = ks_all[_i]
    params = dict(state["params"])
    prior = U.sample_prior_params(spec, hp, params, state["prior"], k_pp)

    # Recompute Mhat fresh each iteration (one full-precision matmul) so the
    # rank-1 updates inside the sweeps cannot accumulate f32 drift across
    # thousands of iterations.
    Mh = m.mhat(params["P"], params["A"], params["E"])

    acc_P = state.get("acc_P")
    acc_E = state.get("acc_E")
    pois_red = None  # streaming metric reductions (stream_sweeps fixed-rank)
    if spec.likelihood == "poisson" and not spec.MH:
        params["P"] = U.sample_P_poisson_gibbs(spec, prior, params, k_P)
        params["E"] = U.sample_E_poisson_gibbs(spec, prior, params, params["P"], k_E)
        Mh = m.mhat(params["P"], params["A"], params["E"])
    elif spec.stream_sweeps:
        # large-G ensembles: NO (C, K, G) tensor exists on this path — the
        # streaming kernels (ops/pallas_stream_sweeps) recompute each Mhat
        # tile in registers for the P/E sweeps, the inclusion sweep
        # (SBFI/BFI), and the metrics-row reductions alike, so the resident
        # footprint is data + E-sized.
        params["P"], acc_P, nan_P = U.stream_sweep_P(
            spec, data, params, prior, acc_P, k_P, accept_all)
        params["E"], acc_E, nan_E = U.stream_sweep_E(
            spec, data, params, prior, acc_E, k_E, accept_all)
        Mh = None  # the metrics reductions stream AFTER the (possible) A sweep
        na_events = nan_P + nan_E
    else:
        params["P"], Mh, acc_P, nan_P = U.sweep_P(
            spec, data, params, prior, Mh, acc_P, k_P, accept_all)
        params["E"], Mh, acc_E, nan_E = U.sweep_E(
            spec, data, params, prior, Mh, acc_E, k_E, accept_all)
        na_events = nan_P + nan_E

    if spec.likelihood == "poisson" and not spec.MH:
        na_events = jnp.float32(0.0)  # conjugate path: no clamped ratios
    if spec.learning_rank:
        params["R"] = U.sample_R(spec, params["A"], temperature, k_R)
        if spec.stream_sweeps:
            params["A"], nan_A = U.stream_sweep_A(
                spec, data, params, params["R"], temperature, k_A)
        else:
            params["A"], Mh, nan_A = U.sweep_A(
                spec, data, params, params["R"], Mh, temperature, k_A)
        na_events = na_events + nan_A

    if spec.stream_sweeps:
        from ..ops import pallas_stream_sweeps as S

        pois_red = S.chain_metrics(
            data, params["E"], params["P"] * params["A"][None, :])

    if spec.needs_Z:
        params["Zsum_g"], params["Zsum_k"] = U.sample_Z_sums(spec, data, params, k_Z)
    if spec.needs_sigmasq:
        params["sigmasq"] = U.sample_sigmasq(spec, data, prior, Mh, k_s)

    new_iter = state["iter"] + 1
    new_state = {"params": params, "prior": prior, "key": k_next, "iter": new_iter}
    if spec.MH:
        new_state["acc_P"] = acc_P
        new_state["acc_E"] = acc_E

    metrics = _metrics_row(spec, data, params, prior, Mh, new_iter, temperature,
                           acc_P, acc_E, na_events, metric_consts, pois_red)
    sample_out = {"metrics": metrics}
    if record != "metrics":
        sample_out |= {"P": params["P"], "E": params["E"], "A": params["A"]}
    if record == "full":
        # full posterior histories (record_sample, bayesNMF_sampler.R:651-672)
        sample_out["prior"] = prior
        if spec.needs_sigmasq:
            sample_out["sigmasq"] = params["sigmasq"]
        if spec.MH:
            sample_out["acc_P"] = acc_P
            sample_out["acc_E"] = acc_E
    return new_state, sample_out


def _metrics_row(spec, data, params, prior, Mh, it, temperature, acc_P, acc_E,
                 na_events=0.0, consts=None, pois_red=None):
    """Per-iteration metrics (compute_metrics_, utils.R:412-455).

    ``consts`` carries the data-only reductions (ops.math.metric_constants),
    hoisted out of the scan by the chunk runners; when None (direct calls,
    e.g. snapshot_sample) they are computed inline — XLA CSEs the lgamma
    pass in a single-step program, so one-off callers lose nothing.
    ``pois_red`` (stream path): the four streamed data-dependent sums from
    ops/pallas_stream_sweeps.chain_metrics, replacing the Mh-consuming
    reductions so Mh may be None.
    """
    if consts is None:
        consts = m.metric_constants(spec.likelihood, data)
    rmse_v = None
    if spec.likelihood == "poisson" and pois_red is not None:
        m_loglam, lam_sum, mp_loglam, sq_err = pois_red
        loglik = m_loglam - lam_sum - consts["lgamma_sum"]
        kl = consts["mlogm_sum"] - mp_loglam
        rmse_v = jnp.sqrt(sq_err / (spec.K * spec.G))
    elif spec.likelihood == "poisson":
        # shared log(max(Mhat, floor)) pass feeds BOTH the loglik and the
        # padded KL (the floors coincide: MHAT_FLOOR == the KL pad, 1e-6)
        lam = jnp.maximum(Mh, m.MHAT_FLOOR)
        L = jnp.log(lam)
        loglik = jnp.sum(data * L) - jnp.sum(lam) - consts["lgamma_sum"]
        kl = consts["mlogm_sum"] - jnp.sum(jnp.maximum(data, 1e-6) * L)
    else:
        loglik = jnp.sum(m.normal_loglik_mat(data, Mh, params["sigmasq"]))
        kl = consts["mlogm_sum"] - jnp.sum(
            jnp.maximum(data, 1e-6) * jnp.log(jnp.maximum(Mh, 1e-6)))
    logpost = loglik + m.logprior_PE(params["P"], params["E"], spec.prior, prior)
    n_par = m.n_params_of(params["A"], spec.K, spec.G)
    if spec.MH:
        w = params["A"][None, :]
        accP_mean = jnp.sum(acc_P * w) / jnp.maximum(jnp.sum(w) * spec.K, 1.0)
        we = params["A"][:, None]
        accE_mean = jnp.sum(acc_E * we) / jnp.maximum(jnp.sum(we) * spec.G, 1.0)
    else:
        accP_mean = jnp.float32(1.0)
        accE_mean = jnp.float32(1.0)
    return jnp.stack([
        it.astype(jnp.float32),
        rmse_v if rmse_v is not None else m.rmse(data, Mh),
        kl,
        loglik,
        logpost,
        n_par.astype(jnp.float32),
        m.bic(loglik, n_par, spec.G),
        jnp.sum(params["A"]),
        jnp.asarray(temperature, jnp.float32),
        accP_mean,
        accE_mean,
        jnp.asarray(na_events, jnp.float32),
    ])


@partial(jax.jit, static_argnames=("spec", "record_full"))
def snapshot_sample(spec: ModelSpec, data, state: dict, temperature,
                    record_full: bool = False):
    """Sample-out record of the *current* state (used for the initial sample,
    bayesNMF_sampler.R:240-257) without advancing the chain."""
    params = state["params"]
    Mh = m.mhat(params["P"], params["A"], params["E"])
    metrics = _metrics_row(
        spec, data, params, state["prior"], Mh, state["iter"], temperature,
        state.get("acc_P"), state.get("acc_E"))
    out = {"P": params["P"], "E": params["E"], "A": params["A"],
           "metrics": metrics}
    if record_full:  # noqa: SIM108 — mirrors gibbs_step's 'full' mode
        out["prior"] = state["prior"]
        if spec.needs_sigmasq:
            out["sigmasq"] = params["sigmasq"]
        if spec.MH:
            out["acc_P"] = state["acc_P"]
            out["acc_E"] = state["acc_E"]
    return out


# ---------------------------------------------------------------------------
# chunked scan runner
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("spec", "accept_all", "record_full",
                                   "record"),
         donate_argnames=("state",))
def run_chunk(spec: ModelSpec, data, hp: dict, state: dict, temps,
              accept_all: bool, record_full: bool = False,
              record: str | None = None):
    """Run ``len(temps)`` Gibbs iterations on device in one lax.scan.

    ``accept_all`` is static: the warmup (accept-all MH proposals,
    MH_Pn_poisson :201-204) and inference phases compile to separate
    specialized programs with zero runtime dispatch.

    Returns (state, samples) where samples stacks per-iteration P/E/A and the
    metrics rows along a leading axis of length len(temps). ``record``
    ('metrics'/'basic'/'full', see gibbs_step) controls the stack contents;
    ``record_full=True`` is the legacy spelling of record='full'.
    """
    if record is None:
        record = "full" if record_full else "basic"

    consts = m.metric_constants(spec.likelihood, data)

    def body(st, temp):
        return gibbs_step(spec, data, hp, st, temp, accept_all, record, consts)

    return jax.lax.scan(body, state, temps)


# ---------------------------------------------------------------------------
# tempering schedule — maps C12 (get_temp_sched_, utils.R:307-332)
# ---------------------------------------------------------------------------


def temp_schedule(length: int, n_temp: int, rng: np.random.Generator | None = None):
    """Log-spaced temperature ladder 0 → 1 over ~n_temp iters, padded with 1s.

    Mirrors get_temp_sched_ (utils.R:307-332) including the 374-level ladder
    constant and the sorted-random-subsample fallback when the ladder exceeds
    ``n_temp``.
    """
    if rng is None:
        rng = np.random.default_rng(0)
    nX = max(int(round(n_temp / 374)), 1)
    sched = [0.0] * nX
    for x in range(9, 4, -1):
        sched += [10.0 ** (-x)] * nX
    sched += [1e-4] * int(round(8 * nX))
    for y in range(4, 0, -1):
        for x in np.arange(0.0, 8.95, 0.1):
            sched += [(1.0 + x) * 10.0 ** (-y)] * nX
    sched = np.asarray(sched, np.float64)
    if len(sched) > n_temp:
        sched = np.sort(rng.choice(sched, size=n_temp, replace=False))
    pad = max(length - len(sched), 0)
    out = np.concatenate([sched, np.ones(pad)])[:length]
    return out.astype(np.float32)
