"""Ensemble parity-surface tests: overrides, full histories, per-chain CIs,
custom MAP windows, compaction, and the parallel-BIC sampler surface.

These cover the reference contracts bayesNMF.R:35-37 (override threading),
bayesNMF_sampler.R:651-672 (full per-iteration histories), utils.R:194-288
(get_MAP windows + elementwise CIs) and bayesNMF.R:117-126 (the BIC winner is
a fully usable sampler object), applied to the ensemble driver the reference
lacks.
"""

import numpy as np
import pytest

from bayesnmf_tpu.config import ConvergenceControl
from bayesnmf_tpu.parallel.ensemble import ChainEnsemble


def _sim(K=16, N=3, G=24, seed=0, scale=30.0):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * scale
    E = rng.gamma(2.0, 2.0, (N, G))
    return rng.poisson(P @ E).astype(np.float32)


CC = ConvergenceControl(MAP_over=40, MAP_every=20, miniters=40, maxiters=120,
                        Ninarow_nochange=2, Ninarow_nobest=3)


@pytest.fixture(scope="module")
def ens():
    e = ChainEnsemble(
        _sim(), 3, n_chains=6, likelihood="poisson", prior="truncnormal",
        MH=True, convergence_control=CC, post_warmup=40, seed=0,
        output_dir=None, record_history="full",
        hyperprior_params={"s_p": 2.5},
    )
    e.run()
    return e


def test_ensemble_full_history_exposes_prior_params(ens):
    s = ens.chain(0).samples
    # full recording carries prior params + acceptance matrices per draw
    for k in ("P", "E", "A", "Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e",
              "acc_P", "acc_E"):
        assert k in s, k
    S = s["P"].shape[0]
    assert s["Mu_p"].shape == (S, ens.spec.K, ens.spec.N)
    assert s["acc_E"].shape == (S, ens.spec.N, ens.spec.G)


def test_ensemble_per_chain_credible_intervals(ens):
    v = ens.chain(1)
    ci = v.credible_intervals
    assert ci is not None and "P" in ci
    keep = len(v.MAP["keep_sigs"])
    assert np.asarray(ci["P"]["lower"]).shape == (ens.spec.K, keep)
    assert np.all(np.asarray(ci["P"]["lower"])
                  <= np.asarray(ci["P"]["upper"]) + 1e-6)


def test_ensemble_custom_map_window(ens):
    v = ens.chain(0)
    end = int(ens._end_iter[0])
    m20 = v.get_MAP(end_iter=end, n_samples=20)
    assert m20["idx"].max() <= end and len(m20["idx"]) <= 20
    # a window after the chain's life raises cleanly, not garbage
    if end < ens.iter - 5:
        with pytest.raises(ValueError):
            v.get_MAP(end_iter=ens.iter, n_samples=5)


def test_ensemble_sampler_surface_for_plots(ens):
    import matplotlib

    matplotlib.use("Agg")
    from bayesnmf_tpu.utils.plotting import plot_sig, plot_signature_dist

    v = ens.chain(0)
    assert np.asarray(v.data).shape == (ens.spec.K, ens.spec.G)
    assert v.sample_metrics.shape[1] == 12
    ref = np.asarray(_sim(), np.float32)[:, :3]  # arbitrary reference
    fig = plot_sig(v, 1, reference_P=ref)
    assert fig is not None
    fig2 = plot_signature_dist(v)
    assert fig2 is not None
    import matplotlib.pyplot as plt

    plt.close("all")


def test_ensemble_compaction_stops_finished_chains(ens):
    # staggered convergence should have compacted the ensemble below its
    # starting size; per-chain bookkeeping keeps original ids
    assert ens._slots.size <= ens.n_chains
    assert all(ens.MAP_per_chain[c] is not None for c in range(ens.n_chains))
    # every finalized chain's BIC window ends at its own _end_iter
    tbl = ens.bic_table()
    assert set(tbl["chain"]) == set(range(ens.n_chains))
    assert np.isfinite(tbl["BIC"]).all()


def test_fit_parallel_bic_threads_overrides_and_full_surface():
    from bayesnmf_tpu.models.sampler import fit

    out = fit(_sim(), [2, 3], rank_method="BIC", convergence_control=CC,
              output_dir=None, post_warmup=40, seed=0,
              hyperprior_params={"s_p": 2.0},
              init_params={"P": np.full((16, 3), 1.0, np.float32)})
    s = out["sampler"]
    assert s.credible_intervals is not None
    assert "dir" in out["results"][0]
    assert {r["rank"] for r in out["results"]} == {2, 3}


def test_fit_parallel_bic_falls_back_to_serial_on_unsupported_kwargs():
    """Every GibbsSampler option is a ChainEnsemble option, so the vmapped
    BIC search takes any kwarg a serial fit takes; the serial per-rank loop
    is reached by asking for it (parallel_bic=False)."""
    import inspect

    from bayesnmf_tpu.models.sampler import GibbsSampler, fit

    def params(f):
        return set(inspect.signature(f).parameters)

    assert params(GibbsSampler.__init__) <= params(ChainEnsemble.__init__)
    out = fit(_sim(), [2, 3], rank_method="BIC", convergence_control=CC,
              output_dir=None, post_warmup=40, seed=0, parallel_bic=False,
              save_all_samples=False)
    assert isinstance(out["sampler"], GibbsSampler)
    assert {r["rank"] for r in out["results"]} == {2, 3}


def test_compaction_preserves_per_chain_inference():
    """Compaction must not change any chain's statistical output: the
    per-chain RNG streams and window boundaries are identical with compact
    on vs off, so convergence iterations and inference windows match
    exactly. (Sample values are bit-identical only up to XLA's batch-size-
    dependent matmul reduction order — an ULP-level difference that MCMC
    chaos amplifies into ordinary Monte-Carlo spread — so the estimates are
    compared as estimates, not bitwise.)"""
    # tight tol + noisy no-best gate stagger convergence across checks
    cc = ConvergenceControl(MAP_over=40, MAP_every=20, miniters=60,
                            maxiters=400, Ninarow_nochange=2,
                            Ninarow_nobest=4, tol=1e-5)
    kw = dict(likelihood="poisson", prior="truncnormal", MH=True,
              convergence_control=cc, post_warmup=40, seed=3,
              output_dir=None, verbosity=0)
    e1 = ChainEnsemble(_sim(), 3, n_chains=6, compact=True, **kw).run()
    e2 = ChainEnsemble(_sim(), 3, n_chains=6, compact=False, **kw).run()
    assert e1._slots.size < 6, "staggering never compacted; weaken CC"
    # identical convergence decisions + windows
    np.testing.assert_array_equal(e1._end_iter, e2._end_iter)
    np.testing.assert_array_equal(e1.tracker.converged_iter,
                                  e2.tracker.converged_iter)
    for c in range(6):
        m1, m2 = e1.MAP_per_chain[c], e2.MAP_per_chain[c]
        np.testing.assert_array_equal(m1["idx"], m2["idx"])
        P1 = np.asarray(m1["P"])
        P2 = np.asarray(m2["P"])
        assert P1.shape == P2.shape
        for j in range(P1.shape[1]):
            cos = (P1[:, j] @ P2[:, j]) / (
                np.linalg.norm(P1[:, j]) * np.linalg.norm(P2[:, j]) + 1e-12)
            assert cos > 0.98, (c, j, cos)


def test_ensemble_view_map_metrics_and_math_getters(ens):
    """The parallel-BIC/ensemble chain view carries the returned-sampler
    contract (bayesNMF.R:117-126): per-check MAP-metric rows
    (update_MAP_metrics_, utils.R:356-397) and the R6 math conveniences
    (bayesNMF_sampler.R:8-541)."""
    v = ens.chain(0)
    assert len(v.MAP_metrics) >= 2
    row = v.MAP_metrics[-1]
    for k in ("iter", "RMSE", "KL", "loglikelihood", "logposterior",
              "n_params", "BIC", "rank", "mean_temp",
              "P_mean_acceptance_rate", "E_mean_acceptance_rate"):
        assert k in row, k
    iters = [r["iter"] for r in v.MAP_metrics]
    assert iters == sorted(iters) and iters[0] % ens.cc.MAP_every == 0
    assert row["BIC"] == pytest.approx(
        -2.0 * row["loglikelihood"] + row["n_params"] * np.log(ens.spec.G))

    Mh = np.asarray(v.get_Mhat())
    assert Mh.shape == (ens.spec.K, ens.spec.G) and (Mh >= 0).all()
    ll = float(v.get_loglik())
    mat = np.asarray(v.get_loglik(return_matrix=True))
    assert mat.shape == (ens.spec.K, ens.spec.G)
    np.testing.assert_allclose(mat.sum(), ll, rtol=1e-5)
    lp = float(v.get_logpost())
    assert np.isfinite(ll) and np.isfinite(lp) and lp != ll


def test_ensemble_view_trace_plot_map_means(ens):
    from bayesnmf_tpu.utils import plotting

    fig = plotting.trace_plot(ens.chain(1), MAP_means=True)
    assert fig is not None
    import matplotlib.pyplot as plt

    plt.close(fig)


@pytest.fixture(scope="module")
def ens_arch():
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=30,
                            maxiters=60, Ninarow_nochange=2, Ninarow_nobest=3)
    e = ChainEnsemble(_sim(seed=3), 3, n_chains=3, likelihood="poisson",
                      prior="truncnormal", MH=True, convergence_control=cc,
                      post_warmup=20, seed=1, output_dir=None,
                      save_all_samples=True)
    e.run()
    return e


def test_ensemble_full_archive_label_switching_and_far_past_window(ens_arch):
    """save_all_samples=True on an ensemble unlocks the label-switching
    diagnostic over ALL iterations (postprocessing_visualizations.R:598-787)
    and arbitrary far-past get_MAP(end_iter=) windows per chain."""
    from bayesnmf_tpu.utils import plotting

    e = ens_arch
    v = e.chain(0)
    arch = v._archive
    assert arch and arch[0]["start_iter"] == 2
    # label-switching plot over the full archive (custom reference matrix)
    rng = np.random.default_rng(0)
    ref = rng.random((e.spec.K, 5)) + 0.1
    fig = plotting.plot_label_switching(v, reference_P=ref)
    assert fig is not None
    import matplotlib.pyplot as plt

    plt.close(fig)
    # a window predating the retained chunks resolves through the archive
    m = v.get_MAP(end_iter=12, n_samples=8)
    assert m["idx"].max() <= 12 and len(m["idx"]) <= 8
    # without an archive the same request on another ensemble raises
    e2 = ChainEnsemble(_sim(seed=3), 3, n_chains=3, likelihood="poisson",
                       prior="truncnormal", MH=True,
                       convergence_control=e.cc, post_warmup=20, seed=1,
                       output_dir=None)
    e2.run()
    with pytest.raises(ValueError):
        plotting.plot_label_switching(e2.chain(0), reference_P=ref)
