"""Streaming-sweep equivalence: the Mhat-free Pallas reduction path must
reproduce the XLA sweep path draw-for-draw (same keys, same sampling math —
only the reduction provider differs, so results match to reduction-order
ULPs).

The kernels compile for the GPU only; off the GPU every test here asks for
the Pallas interpreter explicitly (the autouse fixture below), except the
one that checks the refusal without it. Tests marked ``gpu`` run the
compiled kernels and skip elsewhere."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bayesnmf_tpu.config import ModelSpec, default_hyperprior_params
from bayesnmf_tpu.models import gibbs, updates as U
from bayesnmf_tpu.ops import math as m
from bayesnmf_tpu.ops import pallas_stream_sweeps as S
from stream_reference import (KERNELS, assert_matches_reference,
                              call_kernel, check_kernels_vmapped,
                              kernel_inputs)


@pytest.fixture(autouse=True)
def _interpret_off_gpu():
    on_gpu = jax.default_backend() == "gpu"
    with contextlib.nullcontext() if on_gpu else S.interpret_mode():
        yield


def _setup(K=16, N=3, G=150, prior="truncnormal", seed=0):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * 40
    E = rng.gamma(2.0, 2.0, (N, G))
    data = jnp.asarray(rng.poisson(P @ E).astype(np.float32))
    spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson", prior=prior,
                     MH=True)
    hp = default_hyperprior_params(spec, float(np.asarray(data).mean()))
    state = gibbs.init_state(spec, hp, data, jax.random.PRNGKey(seed))
    return spec, data, state


@pytest.mark.parametrize("prior", ["truncnormal", "exponential"])
@pytest.mark.parametrize("accept_all", [False, True])
def test_stream_sweep_P_matches_xla(prior, accept_all):
    spec, data, state = _setup(prior=prior)
    params, pr = state["params"], state["prior"]
    acc = jnp.zeros((spec.K, spec.N))
    key = jax.random.PRNGKey(7)
    Mh = m.mhat(params["P"], params["A"], params["E"])
    P1, _, a1, nn1 = U.sweep_P(spec, data, params, pr, Mh, acc, key,
                               accept_all)
    P2, a2, nn2 = U.stream_sweep_P(spec, data, params, pr, acc, key,
                                   accept_all)
    np.testing.assert_allclose(np.asarray(P1), np.asarray(P2),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2),
                               rtol=2e-4, atol=2e-5)
    assert float(nn1) == float(nn2) == 0.0


@pytest.mark.parametrize("prior", ["truncnormal", "exponential"])
def test_stream_sweep_E_matches_xla(prior):
    spec, data, state = _setup(prior=prior, seed=3)
    params, pr = state["params"], state["prior"]
    acc = jnp.zeros((spec.N, spec.G))
    key = jax.random.PRNGKey(9)
    Mh = m.mhat(params["P"], params["A"], params["E"])
    E1, _, a1, _ = U.sweep_E(spec, data, params, pr, Mh, acc, key, False)
    E2, a2, _ = U.stream_sweep_E(spec, data, params, pr, acc, key, False)
    np.testing.assert_allclose(np.asarray(E1), np.asarray(E2),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2),
                               rtol=2e-4, atol=2e-5)


def test_stream_sweeps_ragged_tile_and_excluded_column():
    """A G that cannot be a tile multiple exercises the in-kernel ragged
    mask; an excluded column (A_n = 0) must draw from the prior."""
    spec, data, state = _setup(G=131)
    params, pr = state["params"], state["prior"]
    params = dict(params)
    params["A"] = params["A"].at[1].set(0.0)
    acc = jnp.zeros((spec.K, spec.N))
    key = jax.random.PRNGKey(11)
    Mh = m.mhat(params["P"], params["A"], params["E"])
    P1, _, a1, _ = U.sweep_P(spec, data, params, pr, Mh, acc, key, False)
    P2, a2, _ = U.stream_sweep_P(spec, data, params, pr, acc, key, False)
    np.testing.assert_allclose(np.asarray(P1), np.asarray(P2),
                               rtol=2e-4, atol=2e-5)


def test_stream_sweeps_vmapped_over_chains():
    """vmap over a chain axis (the ensemble path) preserves equivalence —
    in particular the in-kernel grid/program_id semantics under batching."""
    spec, data, state = _setup(G=140)
    C = 3
    keys = jax.random.split(jax.random.PRNGKey(0), C)
    from bayesnmf_tpu.parallel import chains as CH

    hp = default_hyperprior_params(spec, float(np.asarray(data).mean()))
    states = CH.init_chain_states(spec, hp, data, jax.random.PRNGKey(1), C)
    params, pr = states["params"], states["prior"]
    acc = jnp.zeros((C, spec.K, spec.N))

    def xla(p, prr, a, k):
        Mh = m.mhat(p["P"], p["A"], p["E"])
        P1, _, a1, _ = U.sweep_P(spec, data, p, prr, Mh, a, k, False)
        return P1, a1

    def stream(p, prr, a, k):
        P2, a2, _ = U.stream_sweep_P(spec, data, p, prr, a, k, False)
        return P2, a2

    P1, a1 = jax.vmap(xla, in_axes=(0, 0, 0, 0))(params, pr, acc, keys)
    P2, a2 = jax.vmap(stream, in_axes=(0, 0, 0, 0))(params, pr, acc, keys)
    np.testing.assert_allclose(np.asarray(P1), np.asarray(P2),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(np.asarray(a1), np.asarray(a2),
                               rtol=2e-4, atol=2e-5)


def test_stream_sweeps_auto_selection_policy():
    """Pin the ensemble default: on the GPU, at a K the kernels take, the
    streaming sweeps serve rank-learning poisson+MH ensembles from the
    measured G crossover on, and any ensemble whose XLA path would not fit
    in device memory; never off the GPU or on a mesh."""
    from bayesnmf_tpu.parallel.ensemble import (_STREAM_SWEEPS_MIN_G,
                                                _XLA_BYTES_PER_CKG,
                                                _auto_stream_sweeps)

    gb80 = 80 * 2**30
    on = dict(likelihood="poisson", prior="truncnormal", MH=True, mesh=None,
              learning_rank=True, C=64, K=96, G=25000, platform="gpu",
              bytes_limit=gb80)
    assert _auto_stream_sweeps(**on)
    assert _auto_stream_sweeps(**{**on, "prior": "exponential"})
    assert _auto_stream_sweeps(**{**on, "G": _STREAM_SWEEPS_MIN_G})
    assert not _auto_stream_sweeps(**{**on, "G": _STREAM_SWEEPS_MIN_G - 1})
    assert not _auto_stream_sweeps(**{**on, "platform": "cpu"})
    assert not _auto_stream_sweeps(**{**on, "mesh": object()})
    assert not _auto_stream_sweeps(**{**on, "MH": False})
    assert not _auto_stream_sweeps(**{**on, "K": S.MAX_K + 1})
    # fixed rank: only where the XLA path would not fit
    fixed = {**on, "learning_rank": False}
    assert not _auto_stream_sweeps(**fixed)
    C_fit = int(gb80 / (_XLA_BYTES_PER_CKG * 96 * 100_000))
    assert not _auto_stream_sweeps(**{**fixed, "C": C_fit, "G": 100_000})
    assert _auto_stream_sweeps(**{**fixed, "C": C_fit + 1, "G": 100_000})
    assert not _auto_stream_sweeps(**{**fixed, "C": C_fit + 1, "G": 100_000,
                                      "platform": "cpu"})

    # spec-level guard
    from bayesnmf_tpu.config import ModelError

    with pytest.raises(ModelError):
        ModelSpec(K=8, N=2, G=16, likelihood="poisson", prior="gamma",
                  MH=False, stream_sweeps=True)


def test_chain_ensemble_runs_on_stream_path():
    """End-to-end ensemble on the streaming path (explicit opt-in at small G
    — CPU interpret mode)."""
    from bayesnmf_tpu.config import ConvergenceControl
    from bayesnmf_tpu.parallel.ensemble import ChainEnsemble

    rng = np.random.default_rng(5)
    P = rng.dirichlet(np.ones(16) * 0.5, 3).T * 40
    E = rng.gamma(2.0, 2.0, (3, 20))
    M = rng.poisson(P @ E).astype(np.float32)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=20,
                            maxiters=40, Ninarow_nochange=2, Ninarow_nobest=3)
    ens = ChainEnsemble(M, 3, n_chains=3, likelihood="poisson",
                        prior="truncnormal", MH=True, convergence_control=cc,
                        post_warmup=10, seed=0, stream_sweeps=True)
    ens.run()
    assert all(m_ is not None for m_ in ens.MAP_per_chain)
    met = ens._metrics_all()
    assert np.isfinite(met[np.isfinite(met[..., 0])][:, 3]).all()


def test_stream_metrics_rows_match_xla_chunk():
    """Full-chunk equivalence incl. the streaming metrics kernel: the same
    keys drive both paths, so every metrics column must agree to
    reduction-order tolerance (the stream path never materializes Mhat;
    its loglik/KL/RMSE come from ops/pallas_stream_sweeps.chain_metrics)."""
    from bayesnmf_tpu.parallel import chains as CH

    rng = np.random.default_rng(2)
    K, N, G, C = 16, 3, 150, 3
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * 40
    E = rng.gamma(2.0, 2.0, (N, G))
    data = jnp.asarray(rng.poisson(P @ E).astype(np.float32))
    rows = {}
    for stream in (False, True):
        spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson",
                         prior="truncnormal", MH=True, stream_sweeps=stream)
        hp = default_hyperprior_params(spec, float(np.asarray(data).mean()))
        states = CH.init_chain_states(spec, hp, data, jax.random.PRNGKey(3),
                                      C)
        temps = jnp.ones((5,), jnp.float32)
        acc = jnp.zeros((C,), bool)
        _, samples = CH.run_chunk_chains(spec, data, hp, states, temps, acc)
        rows[stream] = np.asarray(samples["metrics"])
    np.testing.assert_allclose(rows[True], rows[False], rtol=5e-4, atol=5e-4)


def test_stream_sweep_A_matches_xla():
    """Inclusion-sweep equivalence at matched keys: the streamed per-column
    loglik delta must reproduce sweep_A's decisions (same key structure,
    same penalty/tempering/fallback math)."""
    for rm in ("SBFI", "BFI"):
        spec, data, state = _setup(G=150)
        spec = ModelSpec(K=spec.K, N=spec.N, G=spec.G, likelihood="poisson",
                         prior="truncnormal", MH=True, learning_rank=True,
                         rank_method=rm)
        hp = default_hyperprior_params(spec, float(np.asarray(data).mean()))
        st = gibbs.init_state(spec, hp, data, jax.random.PRNGKey(1))
        params = st["params"]
        key = jax.random.PRNGKey(21)
        R = jnp.int32(2)
        Mh = m.mhat(params["P"], params["A"], params["E"])
        A1, _, nn1 = U.sweep_A(spec, data, params, R, Mh, jnp.float32(0.7),
                               key)
        A2, nn2 = U.stream_sweep_A(spec, data, params, R, jnp.float32(0.7),
                                   key)
        np.testing.assert_array_equal(np.asarray(A1), np.asarray(A2)), rm
        assert float(nn1) == float(nn2)


def test_stream_sbfi_chunk_runs_and_matches():
    """Full SBFI chunk on the stream path matches the XLA path draw-for-draw
    (rank trace, metrics) — the BASELINE config-5 family (SBFI at large G)
    is stream-capable end to end."""
    from bayesnmf_tpu.parallel import chains as CH

    rng = np.random.default_rng(4)
    K, N, G, C = 16, 4, 140, 2
    P = rng.dirichlet(np.ones(K) * 0.5, 2).T * 40
    E = rng.gamma(2.0, 2.0, (2, G))
    data = jnp.asarray(rng.poisson(P @ E).astype(np.float32))
    rows = {}
    for stream in (False, True):
        spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson",
                         prior="truncnormal", MH=True, learning_rank=True,
                         rank_method="SBFI", stream_sweeps=stream)
        hp = default_hyperprior_params(spec, float(np.asarray(data).mean()))
        states = CH.init_chain_states(spec, hp, data, jax.random.PRNGKey(6),
                                      C)
        temps = jnp.asarray(gibbs.temp_schedule(6, 3))
        acc = jnp.ones((C,), bool)
        _, samples = CH.run_chunk_chains(spec, data, hp, states, temps, acc)
        rows[stream] = np.asarray(samples["metrics"])
    # identical rank decisions; metric values match to reduction tolerance
    np.testing.assert_array_equal(rows[True][..., 7], rows[False][..., 7])
    np.testing.assert_allclose(rows[True][..., 1:5], rows[False][..., 1:5],
                               rtol=5e-4, atol=5e-4)


def test_stream_path_full_history_resume_compaction(tmp_path):
    """Seam coverage: the streaming path composed with record_history='full',
    mid-run checkpoint/resume (bit-exact), and live-chain compaction — the
    kind of untested combination that produced round 4's mesh+full crash."""
    from bayesnmf_tpu.config import ConvergenceControl
    from bayesnmf_tpu.parallel.ensemble import ChainEnsemble

    rng = np.random.default_rng(8)
    P = rng.dirichlet(np.ones(16) * 0.5, 3).T * 40
    E = rng.gamma(2.0, 2.0, (3, 24))
    M = rng.poisson(P @ E).astype(np.float32)
    cc = ConvergenceControl(MAP_over=20, MAP_every=10, miniters=40,
                            maxiters=40, Ninarow_nochange=99,
                            Ninarow_nobest=99)
    kw = dict(likelihood="poisson", prior="truncnormal", MH=True,
              convergence_control=cc, post_warmup=10, seed=2,
              output_dir=None, stream_sweeps=True, record_history="full",
              save_all_samples=True)
    e1 = ChainEnsemble(M, 3, n_chains=3, **kw)
    e1.run()
    s = e1.chain(0).samples
    for k in ("P", "E", "A", "Mu_p", "acc_P", "acc_E"):
        assert k in s, k

    e2 = ChainEnsemble(M, 3, n_chains=3, **kw)
    e2._run_chunk(19)
    path = str(tmp_path / "stream_ens.ckpt")
    e2.save_object(path)
    e3 = ChainEnsemble.load(path)
    assert e3.spec.stream_sweeps
    e3.run()
    # bit-exact resume: device states carry the RNG keys
    np.testing.assert_array_equal(
        np.asarray(e1.states["params"]["P"]),
        np.asarray(e3.states["params"]["P"]))
    # the resumed run kept archiving: full history covers the whole run
    assert e3.chain(1)._archive is not None


# ---------------------------------------------------------------------------
# the six kernels against a float64 NumPy reference (tests/stream_reference.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", KERNELS)
@pytest.mark.parametrize("K,N,G", [(96, 5, 1000), (20, 3, 37)])
def test_stream_kernel_matches_reference(name, K, N, G):
    """Ragged G (no tile multiple) and K padded to a power of two
    (96 -> 128, 20 -> 32): padded rows and columns must not leak into any
    sum."""
    x = kernel_inputs(K, N, G)
    assert_matches_reference(name, x, call_kernel(name, x))


def test_stream_kernels_vmapped_over_chains():
    """vmap over a chain axis with the data shared (the ensemble layout):
    every kernel batches, and each chain's result is its own."""
    check_kernels_vmapped(K=24, N=3, G=150, C=3)


@pytest.mark.parametrize("K,G,expect", [
    (96, 25000, (128, 32, 6, 131)),
    (96, 37, (128, 32, 1, 2)),
    (5, 10, (8, 16, 1, 1)),
    (256, 100, (256, 16, 1, 7)),
])
def test_stream_geometry(K, G, expect):
    """Rows pad to a power of two, G tiles are powers of two within the
    block budget, and large G packs several tiles into one block."""
    got = S.geometry(K, G)
    assert got == expect
    Kp, Gt, per_block, n_blocks = got
    assert Kp * Gt <= S._TILE_ELEMS and Gt & (Gt - 1) == 0
    assert per_block * n_blocks * Gt >= G


def test_stream_geometry_rejects_large_K():
    with pytest.raises(ValueError, match="K <="):
        S.geometry(S.MAX_K + 1, 100)


def test_stream_kernel_off_gpu_raises(monkeypatch):
    """Off the GPU, without interpret mode asked for, a kernel refuses to
    run and names the platform."""
    if jax.default_backend() == "gpu":
        pytest.skip("checks the refusal off the GPU")
    monkeypatch.setattr(S, "_interpret", False)
    x = kernel_inputs(8, 2, 20)
    with pytest.raises(RuntimeError, match="'cpu'"):
        call_kernel("pcol_stats", x)


def test_stream_accept_flag_is_per_chain():
    """In a vmapped chunk on the stream path, chains in warmup record
    acceptance 1.0 (accept-all) while the others apply true MH — the flag
    is data, not a compiled constant."""
    from bayesnmf_tpu.parallel import chains as CH

    rng = np.random.default_rng(1)
    K, N, G = 16, 3, 24
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * 30
    E = rng.gamma(2.0, 2.0, (N, G))
    data = jnp.asarray(rng.poisson(P @ E).astype(np.float32))
    spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson",
                     prior="truncnormal", MH=True, stream_sweeps=True)
    hp = default_hyperprior_params(spec, float(data.mean()))
    states = CH.init_chain_states(spec, hp, data, jax.random.PRNGKey(0), 4)
    acc = jnp.asarray([True, False, True, False])
    _, samples = CH.run_chunk_chains(spec, data, hp, states,
                                     jnp.ones((6,), jnp.float32), acc)
    accP = np.asarray(samples["metrics"][:, -1, 9])  # P_mean_acceptance_rate
    assert np.allclose(accP[[0, 2]], 1.0)
    assert (accP[[1, 3]] < 1.0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("name", KERNELS)
def test_stream_kernel_compiled_matches_reference(name):
    """The compiled Triton kernels at a real width (K=96, G=25,000, N=8)."""
    x = kernel_inputs(96, 8, 25000)
    assert_matches_reference(name, x, call_kernel(name, x))
