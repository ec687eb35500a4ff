"""Recovery parity on the reference package's bundled example dataset.

The reference ships inst/extdata/example_data.rds — a simulated 96x64 SBS
catalog generated from 4 true signatures (SURVEY.md L0; tutorial.qmd:34-38).
The acceptance bar is statistical: recovered signatures must match the
bundled ground truth within MCMC variance (BASELINE.json:5).
"""

import numpy as np
import pytest

from bayesnmf_tpu import ConvergenceControl
from bayesnmf_tpu.models.sampler import GibbsSampler
from bayesnmf_tpu.utils.assignment import hungarian_solve, pairwise_cosine
from bayesnmf_tpu.utils.rds import load_example_data


@pytest.fixture(scope="module")
def example():
    d = load_example_data()
    M = np.asarray(d["M"], np.float32)
    P_true = np.asarray(d["P"], np.float32)
    return M, P_true


def matched_cosines(P_est, P_true):
    sim = pairwise_cosine(P_est, P_true)
    cols = hungarian_solve(-sim)
    return np.array([sim[i, c] for i, c in enumerate(cols) if c >= 0])


def test_fixed_rank_recovery_mh(example):
    M, P_true = example
    cc = ConvergenceControl(MAP_over=100, MAP_every=50, miniters=100,
                            maxiters=600, Ninarow_nochange=3, Ninarow_nobest=5)
    s = GibbsSampler(M, 4, likelihood="poisson", prior="truncnormal", MH=True,
                     convergence_control=cc, post_warmup=100, seed=0)
    s.run_gibbs_sampler()
    cos = matched_cosines(np.asarray(s.MAP["P"]), P_true)
    assert cos.min() > 0.9, cos
    assert cos.mean() > 0.95, cos


def test_fixed_rank_recovery_gibbs(example):
    M, P_true = example
    cc = ConvergenceControl(MAP_over=100, MAP_every=50, miniters=100,
                            maxiters=500, Ninarow_nochange=3, Ninarow_nobest=5)
    s = GibbsSampler(M, 4, likelihood="poisson", prior="exponential", MH=False,
                     convergence_control=cc, seed=1)
    s.run_gibbs_sampler()
    cos = matched_cosines(np.asarray(s.MAP["P"]), P_true)
    assert cos.min() > 0.85, cos


@pytest.mark.slow
def test_rank_learning_recovers_4(example):
    M, P_true = example
    cc = ConvergenceControl(MAP_over=100, MAP_every=50, miniters=100,
                            maxiters=1500, Ninarow_nochange=3,
                            Ninarow_nobest=6)
    s = GibbsSampler(M, range(1, 8), likelihood="poisson", prior="truncnormal",
                     MH=True, rank_method="SBFI", convergence_control=cc,
                     prop_temp=0.3, post_warmup=200, seed=0)
    s.run_gibbs_sampler()
    learned = int(np.asarray(s.MAP["A_full"]).sum())
    assert learned == 4, learned
    cos = matched_cosines(np.asarray(s.MAP["P"]), P_true)
    assert cos.min() > 0.9, cos


# ---------------------------------------------------------------------------
# golden values pinned by hand from the R source: these are
# hand-computed from get_temp_sched_ (utils.R:308-332) and
# get_default_*_hyperprior_params_ (setup.R:123-181), NOT from running the
# Python implementation against itself.
# ---------------------------------------------------------------------------


def test_temp_schedule_golden_values():
    """get_temp_sched_ (utils.R:308-332) with nX=1 (n_temp=374): ladder is
    0, 1e-9..1e-5 (one each), 1e-4 held 8, then (1+x)*10^-y for y=4..1 over
    x=0,0.1,...,8.9 (90 values per decade), padded with 1s."""
    from bayesnmf_tpu.models.gibbs import temp_schedule

    s = temp_schedule(length=400, n_temp=374)
    assert s.shape == (400,)
    # hand-derived ladder prefix
    np.testing.assert_allclose(
        s[:14],
        [0.0, 1e-9, 1e-8, 1e-7, 1e-6, 1e-5] + [1e-4] * 8, rtol=1e-6)
    # decade y=4 starts at index 14: (1+0)*1e-4, (1+0.1)*1e-4, ...
    np.testing.assert_allclose(s[14], 1.0e-4, rtol=1e-6)
    np.testing.assert_allclose(s[15], 1.1e-4, rtol=1e-6)
    np.testing.assert_allclose(s[103], 9.9e-4, rtol=1e-6)  # x=8.9, y=4
    # decade y=3 starts at 104
    np.testing.assert_allclose(s[104], 1.0e-3, rtol=1e-6)
    # last ladder entry: (1+8.9)*10^-1 = 0.99 at index 373
    np.testing.assert_allclose(s[373], 0.99, rtol=1e-6)
    # padding to len with exact 1s (utils.R:327-330)
    assert (s[374:] == 1.0).all()
    # monotone non-decreasing throughout
    assert (np.diff(s) >= -1e-12).all()


def test_temp_schedule_nx2_and_subsample():
    from bayesnmf_tpu.models.gibbs import temp_schedule

    # nX = round(748/374) = 2: every level held twice, 1e-4 held 16
    s = temp_schedule(length=800, n_temp=748)
    np.testing.assert_allclose(s[:2], [0.0, 0.0])
    np.testing.assert_allclose(s[2:4], [1e-9, 1e-9], rtol=1e-6)
    assert (s[12:28] == np.float32(1e-4)).all()
    # shorter n_temp than the 374 ladder: sorted random subsample of the
    # ladder (utils.R:322-325), still ends ramping into the 1-padding
    s2 = temp_schedule(length=200, n_temp=100)
    assert s2.shape == (200,)
    assert (np.diff(s2) >= -1e-12).all()
    assert (s2[100:] == 1.0).all()
    assert s2[:100].max() <= 0.99 + 1e-9


def test_hyperprior_defaults_golden_values():
    """Hand-computed from setup.R:123-181 at N=8, mean(M)=25."""
    from bayesnmf_tpu.config import ModelSpec, default_hyperprior_params

    spec = ModelSpec(K=96, N=8, G=100, likelihood="poisson",
                     prior="truncnormal", MH=True)
    hp = default_hyperprior_params(spec, 25.0)
    # s_p = sqrt(mean/N) = sqrt(25/8) = 1.7677669...; a = N+1 = 9; b = sqrt(8)
    np.testing.assert_allclose(hp["m_p"], 0.0)
    np.testing.assert_allclose(hp["s_p"], 1.7677669529663689, rtol=1e-12)
    np.testing.assert_allclose(hp["a_p"], 9.0)
    np.testing.assert_allclose(hp["b_p"], 2.8284271247461903, rtol=1e-12)
    for k in ("m", "s", "a", "b"):
        assert hp[f"{k}_p"] == hp[f"{k}_e"]

    spec_e = ModelSpec(K=96, N=8, G=100, likelihood="poisson",
                       prior="exponential", MH=True)
    hp_e = default_hyperprior_params(spec_e, 25.0)
    # a = 10*sqrt(8) = 28.2842712...; b = 10*sqrt(25) = 50
    np.testing.assert_allclose(hp_e["a_p"], 28.284271247461902, rtol=1e-12)
    np.testing.assert_allclose(hp_e["b_p"], 50.0)
    assert hp_e["a_e"] == hp_e["a_p"] and hp_e["b_e"] == hp_e["b_p"]

    spec_g = ModelSpec(K=96, N=8, G=100, likelihood="poisson", prior="gamma",
                       MH=False)
    hp_g = default_hyperprior_params(spec_g, 25.0)
    # a = 10*sqrt(8); b = 10; c = 10*sqrt(25) = 50; d = 10
    np.testing.assert_allclose(hp_g["a_p"], 28.284271247461902, rtol=1e-12)
    np.testing.assert_allclose(hp_g["b_p"], 10.0)
    np.testing.assert_allclose(hp_g["c_p"], 50.0)
    np.testing.assert_allclose(hp_g["d_p"], 10.0)
