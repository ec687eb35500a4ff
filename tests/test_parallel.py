"""Multi-chain ensembles + mesh sharding on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from bayesnmf_tpu.config import ConvergenceControl, ModelSpec, default_hyperprior_params
from bayesnmf_tpu.parallel import chains as C
from bayesnmf_tpu.parallel import mesh as M
from bayesnmf_tpu.parallel.ensemble import ChainEnsemble


def sim(seed=0, K=12, N=3, G=16, scale=80.0):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * scale
    E = rng.gamma(2.0, 2.0, (N, G))
    return rng.poisson(P @ E).astype(np.float32), P


def test_vmapped_chains_differ_and_are_finite():
    Mdat, _ = sim()
    spec = ModelSpec(K=12, N=3, G=16, likelihood="poisson",
                     prior="exponential", MH=False)
    hp = default_hyperprior_params(spec, float(Mdat.mean()))
    data = jnp.asarray(Mdat)
    states = C.init_chain_states(spec, hp, data, jax.random.PRNGKey(0), 4)
    temps = jnp.ones(5, jnp.float32)
    acc = jnp.zeros(4, bool)
    states, samples = C.run_chunk_chains(spec, data, hp, states, temps, acc)
    P = np.asarray(samples["P"])
    assert P.shape == (4, 5, 12, 3)
    assert np.isfinite(P).all()
    # chains evolve independently (different RNG streams)
    assert not np.allclose(P[0], P[1])


def test_sharded_chain_runner_on_mesh():
    Mdat, _ = sim(G=16)
    spec = ModelSpec(K=12, N=3, G=16, likelihood="poisson",
                     prior="truncnormal", MH=True)
    hp = default_hyperprior_params(spec, float(Mdat.mean()))
    mesh = M.make_mesh(n_chain=4, n_g=2)
    init_fn, run_fn = C.make_sharded_chain_runner(spec, mesh, 8)
    data = jnp.asarray(Mdat)
    states = init_fn(hp, data, jax.random.PRNGKey(1))
    # E is sharded over the g axis of the mesh
    e_shard = states["params"]["E"].sharding
    assert e_shard.spec == jax.sharding.PartitionSpec("chain", None, "g")
    temps = jnp.ones(4, jnp.float32)
    acc = jnp.ones(8, bool)
    states, samples = run_fn(data, hp, states, temps, acc)
    met = np.asarray(samples["metrics"])
    assert met.shape[0] == 8 and np.isfinite(met[..., 1:5]).all()


def test_chain_ensemble_end_to_end():
    Mdat, P_true = sim(seed=3)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                            maxiters=80, Ninarow_nochange=2, Ninarow_nobest=3)
    ens = ChainEnsemble(Mdat, 3, n_chains=4, likelihood="poisson",
                        prior="exponential", MH=False,
                        convergence_control=cc, seed=0)
    ens.run()
    assert ens.tracker.converged.all()
    assert all(m_ is not None for m_ in ens.MAP_per_chain)
    assert ens.throughput() > 0
    # each chain recovers a 3-column MAP
    for m_ in ens.MAP_per_chain:
        assert np.asarray(m_["P"]).shape[0] == 12


def test_chain_ensemble_on_mesh():
    Mdat, _ = sim(seed=4, G=16)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                            maxiters=60, Ninarow_nochange=2, Ninarow_nobest=3)
    mesh = M.make_mesh(n_chain=4, n_g=2)
    ens = ChainEnsemble(Mdat, 3, n_chains=8, likelihood="poisson",
                        prior="truncnormal", MH=True, post_warmup=20,
                        convergence_control=cc, mesh=mesh, seed=1)
    ens.run()
    assert (ens.learned_ranks >= 0).all()


def test_chain_ensemble_on_mesh_full_history():
    """Regression: mesh + record_history='full' raised a jit out_shardings
    pytree-structure error (sample_out_shardings missed the full-record keys
    prior/acc_P/acc_E). The full-history contract (bayesNMF_sampler.R:651-672)
    must hold on a mesh, not just single-chip."""
    Mdat, _ = sim(seed=9, G=16)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                            maxiters=40, Ninarow_nochange=2, Ninarow_nobest=3)
    mesh = M.make_mesh(n_chain=4, n_g=2)
    ens = ChainEnsemble(Mdat, 3, n_chains=8, likelihood="poisson",
                        prior="truncnormal", MH=True, post_warmup=10,
                        convergence_control=cc, mesh=mesh, seed=5,
                        record_history="full")
    ens.run()
    s = ens.chain(0).samples
    for k in ("P", "E", "A", "Mu_p", "Sigmasq_p", "Mu_e", "Sigmasq_e",
              "acc_P", "acc_E"):
        assert k in s, k
    assert np.isfinite(np.asarray(s["Mu_e"])).all()


def test_sharded_runner_full_record_store_E_interplay():
    """store_E=False x record='full' on a mesh: the E stack is pruned from
    the out-sharding pytree exactly like the jitted sample stack, and a
    sigmasq-carrying family (normal likelihood) round-trips its extra keys."""
    Mdat, _ = sim(G=16)
    spec = ModelSpec(K=12, N=3, G=16, likelihood="normal",
                     prior="truncnormal", MH=False)
    hp = default_hyperprior_params(spec, float(Mdat.mean()))
    mesh = M.make_mesh(n_chain=4, n_g=2)
    init_fn, run_fn = C.make_sharded_chain_runner(
        spec, mesh, 8, record="full", store_E=False)
    data = jnp.asarray(Mdat)
    states = init_fn(hp, data, jax.random.PRNGKey(2))
    temps = jnp.ones(3, jnp.float32)
    states, samples = run_fn(data, hp, states, temps, jnp.zeros(8, bool))
    assert "E" not in samples
    for k in ("P", "A", "metrics", "prior", "sigmasq"):
        assert k in samples, k
    # prior stacks keep the state's G layout with an unsharded scan axis
    assert samples["prior"]["Mu_e"].sharding.spec == jax.sharding.PartitionSpec(
        "chain", None, None, "g")
    assert np.isfinite(np.asarray(samples["sigmasq"])).all()


def test_multihost_single_process_paths():
    from bayesnmf_tpu.parallel import multihost as MH

    # off-cluster initialize is a no-op
    assert MH.initialize() is False
    assert MH.n_hosts() == 1

    # single-host global mesh == local mesh layout
    mesh = MH.global_mesh(4, 2)
    assert mesh.shape == {"chain": 4, "g": 2}

    import pytest
    with pytest.raises(ValueError):
        MH.global_mesh(3, 2)  # 6 != 8 devices

    # G-sharded data placement + a sharded ensemble chunk on that mesh
    Mdat, _ = sim(G=16)
    data = MH.shard_data(Mdat, mesh)
    assert data.shape == (12, 16)
    np.testing.assert_allclose(np.asarray(data), Mdat)
    spec = ModelSpec(K=12, N=3, G=16, likelihood="poisson",
                     prior="truncnormal", MH=True)
    hp = default_hyperprior_params(spec, float(Mdat.mean()))
    init, run = C.make_sharded_chain_runner(spec, mesh, n_chains=4)
    states = init(hp, data, jax.random.PRNGKey(0))
    temps = jnp.ones(3, jnp.float32)
    states, samples = run(data, hp, states, temps, jnp.zeros(4, bool))
    assert np.isfinite(np.asarray(samples["metrics"])).all()


def test_ensemble_checkpoint_resume_bitexact(tmp_path):
    """Mid-run checkpoint + resume reproduces the uninterrupted run exactly
    (states carry the RNG keys; temps are indexed by absolute iteration)."""
    Mdat, _ = sim(seed=7)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=40,
                            maxiters=40, Ninarow_nochange=99,
                            Ninarow_nobest=99)
    ens1 = ChainEnsemble(Mdat, 3, n_chains=3, likelihood="poisson",
                         prior="exponential", MH=False,
                         convergence_control=cc, seed=2)
    ens1.run()

    ens2 = ChainEnsemble(Mdat, 3, n_chains=3, likelihood="poisson",
                         prior="exponential", MH=False,
                         convergence_control=cc, seed=2)
    ens2._run_chunk(19)  # to iteration 20, mid-run
    path = str(tmp_path / "ens.ckpt")
    ens2.save_object(path)

    ens3 = ChainEnsemble.load(path)
    assert ens3.iter == 20
    ens3.run()
    assert ens3.iter == ens1.iter
    np.testing.assert_array_equal(
        np.asarray(ens1.states["params"]["P"]),
        np.asarray(ens3.states["params"]["P"]))
    np.testing.assert_array_equal(
        np.asarray(ens1.states["key"]), np.asarray(ens3.states["key"]))
    # MAPs agree too
    for a, b in zip(ens1.MAP_per_chain, ens3.MAP_per_chain):
        np.testing.assert_allclose(np.asarray(a["P"]), np.asarray(b["P"]),
                                   rtol=1e-6)


def test_ensemble_store_E_false_omits_E(tmp_path):
    """store_E=False: MAP omits E (no fabricated zeros) but signature
    assignment still works; summary() refuses informatively."""
    import pytest

    Mdat, P_true = sim(seed=8)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                            maxiters=40, Ninarow_nochange=2, Ninarow_nobest=3)
    ens = ChainEnsemble(Mdat, 3, n_chains=2, likelihood="poisson",
                        prior="exponential", MH=False, store_E=False,
                        convergence_control=cc, seed=3)
    ens.run()
    for m_ in ens.MAP_per_chain:
        assert "E" not in m_
        assert np.asarray(m_["P"]).shape[0] == 12
    res = ens.assign_signatures(reference_P=P_true)
    assert set(res.keys()) == {0, 1}
    assert "MAP_cosine" in res[0]["assignments"].columns
    with pytest.raises(ValueError, match="store_E"):
        ens.summary(reference_P=P_true)


def test_ensemble_postprocessing_and_logging(tmp_path):
    """First-class driver surface: log.txt, periodic checkpoint, per-chain
    assignment, pooled summary with a Chain column."""
    Mdat, P_true = sim(seed=9)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                            maxiters=40, Ninarow_nochange=2, Ninarow_nobest=3)
    od = str(tmp_path / "ens_run")
    ens = ChainEnsemble(Mdat, 3, n_chains=2, likelihood="poisson",
                        prior="exponential", MH=False,
                        convergence_control=cc, seed=4, output_dir=od)
    ens.run()
    import os

    assert os.path.exists(os.path.join(ens.output_dir, "log.txt"))
    assert os.path.exists(os.path.join(ens.output_dir, "ensemble.ckpt"))
    log_txt = open(os.path.join(ens.output_dir, "log.txt")).read()
    assert "chains" in log_txt

    summ = ens.summary(reference_P=P_true)
    assert "Chain" in summ.columns
    assert set(summ["Chain"].unique()) == {0, 1}
    pooled = ens.pooled_assignment(reference_P=P_true)
    assert (pooled["prop_chains"] <= 1.0).all()
    assert pooled["n_chains"].sum() >= 2


def test_single_chain_g_sharded_sampler():
    """One large fit spans the mesh: E/Zsum_k/data sharded over 'g', GSPMD
    inserts the psums for the sweeps' G-contractions."""
    from bayesnmf_tpu.models.sampler import GibbsSampler

    Mdat, _ = sim(seed=10, G=32)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                            maxiters=40, Ninarow_nochange=2, Ninarow_nobest=3)
    mesh = M.make_mesh(n_chain=1, n_g=8)
    s = GibbsSampler(Mdat, 3, likelihood="poisson", prior="truncnormal",
                     MH=True, post_warmup=20, convergence_control=cc,
                     mesh=mesh, seed=6)
    assert s.state["params"]["E"].sharding.spec == jax.sharding.PartitionSpec(
        None, "g")
    assert s.data.sharding.spec == jax.sharding.PartitionSpec(None, "g")
    s.run_gibbs_sampler()
    assert s.MAP is not None
    met = s.sample_metrics
    assert np.isfinite(met["loglikelihood"].to_numpy()[1:]).all()
    # matches the unsharded run statistically: same seed, same kernel — the
    # scan program differs only in layout, so final loglik must be close
    s2 = GibbsSampler(Mdat, 3, likelihood="poisson", prior="truncnormal",
                      MH=True, post_warmup=20, convergence_control=cc, seed=6)
    s2.run_gibbs_sampler()
    ll1 = met["loglikelihood"].to_numpy()[-1]
    ll2 = s2.sample_metrics["loglikelihood"].to_numpy()[-1]
    assert abs(ll1 - ll2) / max(abs(ll2), 1.0) < 0.05


def test_stream_sweeps_rejects_mesh():
    """The streaming kernels do not partition over a G-sharded mesh, so an
    explicit request for both is refused up front."""
    import pytest

    Mdat, _ = sim(seed=11, G=16)
    mesh = M.make_mesh(n_chain=4, n_g=2)
    with pytest.raises(ValueError, match="stream_sweeps"):
        ChainEnsemble(Mdat, 3, n_chains=4, likelihood="poisson",
                      prior="truncnormal", MH=True, mesh=mesh,
                      stream_sweeps=True)


def test_chain_dp_hot_loop_has_no_collectives():
    """Chain-parallel scaling validation that works on shared-core virtual
    devices: the compiled chain-dp chunk program must contain NO collectives
    (chains never communicate in the hot loop ⇒ real-hardware chain scaling
    is linear up to data replication), while a (chain, g) mesh MUST insert
    all-reduces for the sweeps' cross-G contractions."""
    spec = ModelSpec(K=12, N=3, G=16, likelihood="poisson",
                     prior="truncnormal", MH=True)
    hp = default_hyperprior_params(spec, 20.0)
    Mdat, _ = sim(G=16)
    data = jnp.asarray(Mdat)
    temps = jnp.ones(2, jnp.float32)

    def compiled_text(n_chain, n_g, n_chains):
        mesh = M.make_mesh(n_chain=n_chain, n_g=n_g)
        init, run = C.make_sharded_chain_runner(spec, mesh, n_chains)
        states = init(hp, data, jax.random.PRNGKey(0))
        acc = jnp.zeros((n_chains,), bool)
        from bayesnmf_tpu.parallel import mesh as Mm

        data_sh = jax.device_put(data, Mm.data_sharding(mesh))
        jitted = jax.jit(
            lambda d, h, s, t, a: C.run_chunk_chains(spec, d, h, s, t, a))
        return jitted.lower(data_sh, hp, states, temps,
                            acc).compile().as_text()

    coll = ("all-reduce", "all-gather", "all-to-all", "collective-permute",
            "reduce-scatter")
    txt_dp = compiled_text(8, 1, 8)
    assert not any(c in txt_dp for c in coll), (
        "chain-dp program unexpectedly communicates: " +
        ",".join(c for c in coll if c in txt_dp))
    txt_gs = compiled_text(4, 2, 8)
    assert any(c in txt_gs for c in coll), (
        "G-sharded program has no collectives — G reductions not distributed")
