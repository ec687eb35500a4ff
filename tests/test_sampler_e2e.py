"""End-to-end driver tests: full runs with convergence, MAP, checkpointing.

Stands in for the reference's executable-vignette acceptance tests
(SURVEY.md §4); uses deliberately short convergence controls like
advanced.qmd:107-115.
"""

import numpy as np
import pytest

from bayesnmf_tpu import ConvergenceControl
from bayesnmf_tpu.models.sampler import GibbsSampler, fit


def sim_data(seed=0, K=16, N=3, G=24, scale=100.0):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * scale
    E = rng.gamma(2.0, 2.0, (N, G))
    M = rng.poisson(P @ E).astype(np.float32)
    return M, P.astype(np.float32), E.astype(np.float32)


CC = ConvergenceControl(MAP_over=40, MAP_every=20, miniters=40, maxiters=200,
                        Ninarow_nochange=3, Ninarow_nobest=5)


def cosine_match(P_est, P_true):
    """Mean best-match cosine of estimated to true signatures."""
    a = P_est / np.maximum(np.linalg.norm(P_est, axis=0), 1e-30)
    b = P_true / np.maximum(np.linalg.norm(P_true, axis=0), 1e-30)
    sim = a.T @ b
    from bayesnmf_tpu.utils.assignment import hungarian_solve

    cols = hungarian_solve(-sim)
    return np.mean([sim[i, c] for i, c in enumerate(cols) if c >= 0])


def test_fixed_rank_poisson_exponential_recovery(tmp_path):
    M, P_true, _ = sim_data()
    s = GibbsSampler(M, 3, likelihood="poisson", prior="exponential",
                     MH=False, convergence_control=CC,
                     output_dir=str(tmp_path / "run"), seed=1)
    s.run_gibbs_sampler()
    assert s.tracker.converged
    assert s.MAP is not None
    P_map = np.asarray(s.MAP["P"])
    assert cosine_match(P_map, P_true) > 0.85
    # metrics exist for every iteration
    df = s.sample_metrics
    assert df.shape[0] == s.iter
    assert np.isfinite(df["loglikelihood"].to_numpy()).all()
    # log file written
    log = (tmp_path / "run" / "log.txt").read_text()
    assert "Starting Gibbs sampler" in log and "Sampler done" in log


def test_mh_truncnormal_run(tmp_path):
    M, P_true, _ = sim_data(seed=3)
    cc = ConvergenceControl(MAP_over=40, MAP_every=20, miniters=40,
                            maxiters=120, Ninarow_nochange=3,
                            Ninarow_nobest=5)
    s = GibbsSampler(M, 3, likelihood="poisson", prior="truncnormal", MH=True,
                     convergence_control=cc, post_warmup=60,
                     output_dir=None, seed=2)
    s.run_gibbs_sampler()
    # total iterations = warmup + post_warmup
    assert s.iter == s.tracker.converged_iter + 60
    # acceptance rates recorded and within [0,1]
    df = s.sample_metrics
    acc = df["P_mean_acceptance_rate"].to_numpy()
    assert ((acc >= 0) & (acc <= 1.0001)).all()
    # during warmup accept-all → rates 1
    assert acc[10] == 1.0
    assert cosine_match(np.asarray(s.MAP["P"]), P_true) > 0.8


def test_rank_learning_sbfi(tmp_path):
    # rank learning uses the reference's flagship Poisson-TruncNormal+MH
    # config: the accept-all warmup refits reintroduced signatures instantly,
    # which is what makes SBFI exploration mix (the non-MH Poisson-Gibbs path
    # reintroduces mass too slowly for rank moves, as in the reference).
    rng = np.random.default_rng(5)
    K, N_true, G = 32, 3, 32
    P_true = rng.dirichlet(np.ones(K) * 0.5, N_true).T
    E_true = rng.gamma(2.0, 150.0, (N_true, G))
    M = rng.poisson(P_true @ E_true).astype(np.float32)
    cc = ConvergenceControl(MAP_over=100, MAP_every=50, miniters=100,
                            maxiters=1500, Ninarow_nochange=3,
                            Ninarow_nobest=6)
    s = GibbsSampler(M, range(1, 7), likelihood="poisson", prior="truncnormal",
                     MH=True, rank_method="SBFI", convergence_control=cc,
                     prop_temp=0.3, post_warmup=200, seed=5)
    s.run_gibbs_sampler()
    learned_rank = int(np.asarray(s.MAP["A_full"]).sum())
    assert learned_rank == 3
    # final MAP is filtered to included signatures
    assert np.asarray(s.MAP["P"]).shape[1] == len(s.MAP["keep_sigs"])
    assert cosine_match(np.asarray(s.MAP["P"]), P_true) > 0.9


def test_checkpoint_resume_bit_exact(tmp_path):
    M, _, _ = sim_data(seed=7)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                            maxiters=60, Ninarow_nochange=2, Ninarow_nobest=3)
    kw = dict(likelihood="poisson", prior="exponential", MH=False,
              convergence_control=cc, seed=9)
    # full run
    s1 = GibbsSampler(M, 3, **kw)
    s1.run_gibbs_sampler()
    # interrupted run: stop after first chunk, checkpoint, resume
    s2 = GibbsSampler(M, 3, **kw)
    s2._run_chunk(9, accept_all=False)  # iterations 2..10
    path = str(tmp_path / "ckpt.pkl")
    s2.save_object(path)
    s3 = GibbsSampler.load(path)
    assert s3.iter == s2.iter
    np.testing.assert_array_equal(
        np.asarray(s3.state["params"]["P"]), np.asarray(s2.state["params"]["P"]))
    s3.run_gibbs_sampler()
    assert s3.tracker.converged
    # same seed full run and resumed run agree on final state (same RNG path)
    np.testing.assert_allclose(
        np.asarray(s1.state["params"]["P"]),
        np.asarray(s3.state["params"]["P"]), rtol=1e-5)


def test_fit_bic_rank_selection(tmp_path):
    M, _, _ = sim_data(seed=11, N=2, K=12, G=16, scale=80.0)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                            maxiters=60, Ninarow_nochange=2, Ninarow_nobest=3)
    out = fit(M, [1, 2, 3], likelihood="poisson", prior="exponential",
              MH=False, rank_method="BIC", convergence_control=cc,
              output_dir=str(tmp_path / "bic"), seed=3, parallel_bic=False)
    assert set(out.keys()) == {"results", "best_rank", "sampler"}
    assert out["results"][0]["BIC"] == min(r["BIC"] for r in out["results"])
    assert out["best_rank"] in (1, 2, 3)


def test_fit_bic_parallel(tmp_path):
    """The vmapped min-BIC search: every candidate rank as one device
    program via fixed per-chain A masks (vs the reference's serial lapply,
    bayesNMF.R:67-105)."""
    M, _, _ = sim_data(seed=11, N=2, K=12, G=16, scale=80.0)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                            maxiters=60, Ninarow_nochange=2, Ninarow_nobest=3)
    out = fit(M, [1, 2, 3], likelihood="poisson", prior="exponential",
              MH=False, rank_method="BIC", convergence_control=cc,
              output_dir=str(tmp_path / "bicp"), seed=3)
    assert {"results", "best_rank", "sampler", "ensemble"} <= set(out.keys())
    assert out["results"][0]["BIC"] == min(r["BIC"] for r in out["results"])
    assert out["best_rank"] in (1, 2, 3)
    ens = out["ensemble"]
    # the masks pinned each chain's rank for the whole run
    np.testing.assert_array_equal(
        np.asarray(ens.states["params"]["A"]),
        np.array([[1, 0, 0], [1, 1, 0], [1, 1, 1]], np.float32))
    # per-chain metrics report the masked rank every iteration
    ranks_hist = np.concatenate(ens._metric_rows, axis=1)[:, :, 7]
    np.testing.assert_array_equal(ranks_hist[:, -1], [1.0, 2.0, 3.0])
    # the true rank (2) should beat rank 1 decisively on BIC for this data
    table = ens.bic_table().set_index("rank")
    assert table.loc[2, "BIC"] < table.loc[1, "BIC"]
    # the returned best-chain view supports the postprocessing entry points
    assert out["sampler"].MAP is not None


def test_get_map_custom_window():
    M, _, _ = sim_data(seed=13)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                            maxiters=50, Ninarow_nochange=2, Ninarow_nobest=3)
    s = GibbsSampler(M, 2, likelihood="poisson", prior="exponential", MH=False,
                     convergence_control=cc, save_all_samples=True, seed=5)
    s.run_gibbs_sampler()
    res = s.get_MAP(end_iter=30, n_samples=10)
    assert res["P"].shape == (16, 2)
    assert res["idx"].max() <= 30
    # windows not retained raise without save_all_samples
    s2 = GibbsSampler(M, 2, likelihood="poisson", prior="exponential",
                      MH=False, convergence_control=cc,
                      save_all_samples=False, seed=5)
    s2.run_gibbs_sampler()
    with pytest.raises(ValueError):
        s2.get_MAP(end_iter=30, n_samples=10)
