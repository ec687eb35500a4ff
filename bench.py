"""Benchmarks for the 5 BASELINE.json configs.

Default (no args) prints one JSON line PER config, headline first —
config 2 (96x500 Poisson-TruncNormal+MH, fixed K=8, single chain):
{"metric", "value", "unit", "vs_baseline"} — then configs 1, 3, 4, 5.

Other modes (each prints one JSON line per config):
  --config 1   96x100 Poisson-Exponential Gibbs, K=5 (latent-count
               allocation path; vs a NumPy rmultinom-loop baseline)
  --config 2   the default headline
  --config 3   SBFI rank learning K in 1..20 on 96x1000 (the north-star
               config) + the fixed-rank cost at the same size
  --config 4   PCAWG-scale 96x2780 end-to-end fit + COSMIC ensemble
               assignment wall-clock
  --config 5   many-chain x large-G throughput on one device (metrics-only
               recording; streaming kernels vs the XLA path, plus the FULL
               256-chain x 96x100k SBFI shape on the streaming path)
  --multiproc  1-process vs 2-process chain throughput (jax.distributed,
               CPU gloo)
  --bic        parallel (one vmapped program) vs serial min-BIC rank-search
               wall-clock speedup at 8 candidate ranks, 96x500
  --chains N   N-chain throughput at config-2 size (XLA sweep path)
  --scaling    chain-scaling efficiency on a virtual CPU mesh (run with
               JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8)
  --all        configs 1-5

``vs_baseline`` compares against a single-core NumPy re-implementation of the
reference's per-iteration algorithm (same O(N^2*K*G) full-matmul column sweep
and 4 full loglik evaluations per MH update that bayesNMF does in R —
sample_Pn.R:132-248; same K*G rmultinom loop for the Gibbs path —
sample_params.R:253-265). The R package itself is not installable in this
image (no R runtime; BASELINE.md notes no published numbers exist either), so
this stands in as a faithful, favorable-to-the-reference CPU baseline:
NumPy's BLAS-backed ops are at least as fast as the R equivalents.
"""

import json
import time

import numpy as np

K, N, G = 96, 8, 500
BENCH_ITERS = 3000
BASELINE_ITERS = 20


def _sim_data(seed=0, K=96, N=8, G=500, scale=100.0):
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.ones(K) * 0.5, N).T * scale
    E = rng.gamma(2.0, 2.0, (N, G))
    return rng.poisson(P @ E).astype(np.float32)


def bench_config(K, N, G, likelihood, prior, MH, *, learning_rank=False,
                 rank_method="SBFI", iters=BENCH_ITERS, record="basic",
                 reps=3, seed=0, temps_at_one=True):
    """Steady-state Gibbs iterations/sec for one single-chain config."""
    import jax
    import jax.numpy as jnp

    from bayesnmf_tpu.config import ModelSpec, default_hyperprior_params
    from bayesnmf_tpu.models import gibbs

    data = _sim_data(seed=seed, K=K, N=N, G=G)
    spec = ModelSpec(K=K, N=N, G=G, likelihood=likelihood, prior=prior,
                     MH=MH, learning_rank=learning_rank,
                     rank_method=rank_method)
    hp = default_hyperprior_params(spec, float(data.mean()))
    d = jnp.asarray(data)
    state = gibbs.init_state(spec, hp, d, jax.random.PRNGKey(seed))
    temps = jnp.ones((iters,), jnp.float32)
    if not temps_at_one:
        temps = jnp.asarray(gibbs.temp_schedule(iters, iters))

    # compile + warmup with the SAME chunk length as the timed run (a
    # different scan length is a different XLA program)
    state, samples = gibbs.run_chunk(spec, d, hp, state, temps, False,
                                     record=record)
    jax.block_until_ready(samples)

    t0 = time.perf_counter()
    for _ in range(reps):
        state, samples = gibbs.run_chunk(spec, d, hp, state, temps, False,
                                         record=record)
        jax.block_until_ready(samples)
    dt = (time.perf_counter() - t0) / reps
    return iters / dt


# ---------------------------------------------------------------------------
# NumPy baselines (single core, reference algorithm shape)
# ---------------------------------------------------------------------------


def baseline_numpy_mh(data, N, iters=BASELINE_ITERS, seed=1):
    """Single-core NumPy mirror of the reference's MH per-iteration work:
    sequential column sweep with TWO full KxG Mhat recomputations per column
    (sample_Pn.R:136,152) and 4 full loglik matrices per MH acceptance
    (sample_Pn.R:209-239), for both the P and E sweeps."""
    from scipy.special import gammaln

    rng = np.random.default_rng(seed)
    Kd, Gd = data.shape
    M = data.astype(np.float64)
    P = rng.gamma(1.0, 1.0, (Kd, N))
    E = rng.gamma(1.0, 1.0, (N, Gd))
    Mu_p, Sq_p = np.zeros((Kd, N)), np.ones((Kd, N))
    Mu_e, Sq_e = np.zeros((N, Gd)), np.ones((N, Gd))

    def pois_ll(M, lam):
        lam = np.maximum(lam, 1e-6)
        return M * np.log(lam) - lam - gammaln(M + 1)

    def norm_ll(M, mean, var):
        return -0.5 * (M - mean) ** 2 / var - 0.5 * np.log(2 * np.pi * var)

    t0 = time.perf_counter()
    for _ in range(iters):
        for n in range(N):
            Mh = P @ E                           # full matmul (as reference)
            sig = Mh.copy()
            Pc = P.copy(); Pc[:, n] = 0
            Mh_no_n = Pc @ E                     # second full matmul
            resid = (M - Mh_no_n) / np.maximum(sig, 1e-6)
            mu1 = resid @ E[n]
            den = (1 / np.maximum(sig, 1e-6)) @ (E[n] ** 2) + 1 / Sq_p[:, n]
            mu = (mu1 + Mu_p[:, n] / Sq_p[:, n]) / den
            prop = np.maximum(mu + rng.normal(size=Kd) / np.sqrt(den), 0)
            Pp = P.copy(); Pp[:, n] = prop
            Mh_prop = Pp @ E
            lp_old = pois_ll(M, Mh).sum(1)
            lp_new = pois_ll(M, Mh_prop).sum(1)
            ln_old = norm_ll(M, Mh, np.maximum(Mh_prop, 1)).sum(1)
            ln_new = norm_ll(M, Mh_prop, np.maximum(Mh, 1)).sum(1)
            # min(exp(d), 1) == exp(min(d, 0)): clamp so np.exp can't overflow
            ratio = np.exp(np.minimum(lp_new + ln_old - lp_old - ln_new, 0.0))
            acc = rng.random(Kd) < ratio
            P[acc, n] = prop[acc]
        for n in range(N):
            Mh = P @ E
            sig = Mh.copy()
            Ec = E.copy(); Ec[n] = 0
            Mh_no_n = P @ Ec
            resid = (M - Mh_no_n) / np.maximum(sig, 1e-6)
            mu1 = P[:, n] @ resid
            den = (P[:, n] ** 2) @ (1 / np.maximum(sig, 1e-6)) + 1 / Sq_e[n]
            mu = (mu1 + Mu_e[n] / Sq_e[n]) / den
            prop = np.maximum(mu + rng.normal(size=Gd) / np.sqrt(den), 0)
            Ep = E.copy(); Ep[n] = prop
            Mh_prop = P @ Ep
            lp_old = pois_ll(M, Mh).sum(0)
            lp_new = pois_ll(M, Mh_prop).sum(0)
            ln_old = norm_ll(M, Mh, np.maximum(Mh_prop, 1)).sum(0)
            ln_new = norm_ll(M, Mh_prop, np.maximum(Mh, 1)).sum(0)
            ratio = np.exp(np.minimum(lp_new + ln_old - lp_old - ln_new, 0.0))
            acc = rng.random(Gd) < ratio
            E[n, acc] = prop[acc]
    return iters / (time.perf_counter() - t0)


def baseline_numpy_gibbs(data, N, iters=BASELINE_ITERS, seed=1):
    """NumPy mirror of the conjugate Poisson-Gibbs iteration: the K*G
    per-cell rmultinom latent-count loop (sample_Zkg, sample_params.R:253-265)
    followed by per-column Gamma draws for P and E (sample_Pn.R:98-120)."""
    rng = np.random.default_rng(seed)
    Kd, Gd = data.shape
    M = data.astype(np.int64)
    P = rng.gamma(1.0, 1.0, (Kd, N))
    E = rng.gamma(1.0, 1.0, (N, Gd))
    t0 = time.perf_counter()
    for _ in range(iters):
        Zsum_g = np.zeros((Kd, N))
        Zsum_k = np.zeros((N, Gd))
        for k in range(Kd):          # the reference's double loop over cells
            pk = P[k]
            for g in range(Gd):
                w = pk * E[:, g]
                s = w.sum()
                if s <= 0 or M[k, g] == 0:
                    continue
                z = rng.multinomial(M[k, g], w / s)
                Zsum_g[k] += z
                Zsum_k[:, g] += z
        P = rng.gamma(1.0 + Zsum_g, 1.0 / (1.0 + E.sum(axis=1))[None, :])
        E = rng.gamma(1.0 + Zsum_k, 1.0 / (1.0 + P.sum(axis=0))[:, None])
    return iters / (time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def config1():
    """96x100 Poisson-Exponential Gibbs, fixed K=5 (the XLA binomial-tree
    latent-count allocation)."""
    data = _sim_data(seed=0, K=96, N=5, G=100)
    ips = bench_config(96, 5, 100, "poisson", "exponential", False,
                       iters=BENCH_ITERS)
    base = baseline_numpy_gibbs(data, 5, iters=5)
    return {"metric": "gibbs_iters_per_sec_96x100_K5_poisson_exp_gibbs",
            "value": round(ips, 2), "unit": "iterations/sec/chip",
            "vs_baseline": round(ips / base, 2)}


def config2():
    """96x500 Poisson-TruncNormal+MH fixed K=8 (headline)."""
    data = _sim_data(seed=0, K=96, N=8, G=500)
    ips = bench_config(96, 8, 500, "poisson", "truncnormal", True,
                       iters=BENCH_ITERS)
    base = baseline_numpy_mh(data, 8, iters=BASELINE_ITERS)
    return {"metric": "gibbs_iters_per_sec_96x500_K8_poisson_truncnormal_MH",
            "value": round(ips, 2), "unit": "iterations/sec/chip",
            "vs_baseline": round(ips / base, 2), "default_flags": True}


def config3():
    """SBFI rank learning K in 1..20 on 96x1000 (the north-star config)."""
    data = _sim_data(seed=0, K=96, N=20, G=1000)
    ips_sbfi = bench_config(96, 20, 1000, "poisson", "truncnormal", True,
                            learning_rank=True, rank_method="SBFI",
                            iters=BENCH_ITERS)
    ips_fixed = bench_config(96, 20, 1000, "poisson", "truncnormal", True,
                             iters=BENCH_ITERS)
    base = baseline_numpy_mh(data, 20, iters=5)
    return {"metric": "sbfi_iters_per_sec_96x1000_K1to20",
            "value": round(ips_sbfi, 2), "unit": "iterations/sec/chip",
            "vs_baseline": round(ips_sbfi / base, 2),
            "fixed_rank_iters_per_sec": round(ips_fixed, 2),
            "rank_learning_overhead_x": round(ips_fixed / ips_sbfi, 3)}


def config4():
    """PCAWG-scale end-to-end: 96x2780 fit + COSMIC ensemble assignment."""
    import pandas as pd

    from bayesnmf_tpu.config import ConvergenceControl
    from bayesnmf_tpu.models.sampler import GibbsSampler
    from bayesnmf_tpu.utils.cosmic import get_cosmic

    cosmic = get_cosmic()
    rng = np.random.default_rng(0)
    sig_idx = rng.choice(cosmic.shape[1], 6, replace=False)
    P_true = cosmic.to_numpy()[:, sig_idx]
    E_true = rng.gamma(1.5, 200.0, (6, 2780))
    data = rng.poisson(P_true @ E_true).astype(np.float32)
    df = pd.DataFrame(data, index=list(cosmic.index))

    cc = ConvergenceControl(MAP_over=300, MAP_every=150, miniters=600,
                            maxiters=1200, Ninarow_nochange=3,
                            Ninarow_nobest=5)

    def one_fit(seed):
        t0 = time.perf_counter()
        s = GibbsSampler(df, 6, likelihood="poisson", prior="truncnormal",
                         MH=True, convergence_control=cc, post_warmup=300,
                         output_dir=None, seed=seed)
        s.run_gibbs_sampler()
        return s, time.perf_counter() - t0

    s, cold_s = one_fit(0)
    # warm fit: identical shapes → every XLA program is already compiled.
    # This is the production-relevant number when screening many cohorts
    # (and the steady state with a persistent compile cache).
    s, fit_s = one_fit(1)
    t1 = time.perf_counter()
    res = s.assign_signatures_ensemble("cosmic")
    assign_s = time.perf_counter() - t1
    cos = res["assignments"]["MAP_cosine"].to_numpy(float)
    return {"metric": "pcawg_scale_96x2780_end_to_end",
            "value": round(fit_s + assign_s, 2), "unit": "seconds",
            "vs_baseline": None,
            "cold_fit_seconds_incl_compiles": round(cold_s, 2),
            "fit_seconds": round(fit_s, 2),
            "assign_seconds": round(assign_s, 2),
            "iters": int(s.iter),
            "iters_per_sec": round(s.iter / fit_s, 2),
            "mean_MAP_cosine": round(float(np.nanmean(cos)), 4)}


def config5(n_chains=64, G_big=25000):
    """Many-chain x large-G single-device throughput (metrics-only
    recording; the stacked sample history would dominate device memory at
    this size), streaming kernels vs the XLA path, plus the full 256-chain
    x 96x100k SBFI shape on the streaming path."""
    import jax
    import jax.numpy as jnp

    from bayesnmf_tpu.config import ModelSpec, default_hyperprior_params
    from bayesnmf_tpu.parallel import chains as C

    data = _sim_data(seed=0, K=96, N=8, G=G_big, scale=50.0)

    def run_path(stream):
        spec = ModelSpec(K=96, N=8, G=G_big, likelihood="poisson",
                         prior="truncnormal", MH=True, stream_sweeps=stream)
        hp = default_hyperprior_params(spec, float(data.mean()))
        d = jnp.asarray(data)
        states = C.init_chain_states(spec, hp, d, jax.random.PRNGKey(0),
                                     n_chains)
        iters = 50
        temps = jnp.ones((iters,), jnp.float32)
        acc = jnp.zeros((n_chains,), bool)
        states, samples = C.run_chunk_chains(spec, d, hp, states, temps, acc,
                                             record="metrics")
        jax.block_until_ready(samples)
        t0 = time.perf_counter()
        states, samples = C.run_chunk_chains(spec, d, hp, states, temps, acc,
                                             record="metrics")
        jax.block_until_ready(samples)
        return n_chains * iters / (time.perf_counter() - t0)

    # streaming sweeps are the GPU ensemble default at this G
    # (parallel/ensemble._auto_stream_sweeps); the XLA path rides along
    cips = run_path(True)
    cips_xla = run_path(False)
    row = {"metric": f"chain_iters_per_sec_{n_chains}chains_96x{G_big}_MH",
           "value": round(cips, 2),
           "unit": "chain-iterations/sec/chip", "vs_baseline": None,
           "xla_path_chain_iters_per_sec": round(cips_xla, 2),
           "stream_vs_xla_x": round(cips / cips_xla, 3)}
    # The FULL BASELINE config-5 spec — 256 vmapped chains x 96x100k, SBFI —
    # on the stream path: no (C, K, G) tensor exists anywhere in the program
    # (Mhat lives only in kernel registers for the P/E sweeps, the inclusion
    # sweep, and the metrics row alike).
    try:
        spec = ModelSpec(K=96, N=8, G=100_000, likelihood="poisson",
                         prior="truncnormal", MH=True, learning_rank=True,
                         rank_method="SBFI", stream_sweeps=True)
        data_f = _sim_data(seed=0, K=96, N=8, G=100_000, scale=50.0)
        hp = default_hyperprior_params(spec, float(data_f.mean()))
        d = jnp.asarray(data_f)
        states = C.init_chain_states(spec, hp, d, jax.random.PRNGKey(0), 256)
        iters = 10
        temps = jnp.ones((iters,), jnp.float32)
        acc = jnp.zeros((256,), bool)
        states, samples = C.run_chunk_chains(spec, d, hp, states, temps, acc,
                                             record="metrics")
        jax.block_until_ready(samples)
        t0 = time.perf_counter()
        states, samples = C.run_chunk_chains(spec, d, hp, states, temps, acc,
                                             record="metrics")
        jax.block_until_ready(samples)
        row["full_scale_256chains_96x100k_SBFI_chain_iters_per_sec"] = round(
            256 * iters / (time.perf_counter() - t0), 2)
    except Exception as e:  # pragma: no cover - OOM guard on small devices
        row["full_scale_256chains_96x100k_SBFI_chain_iters_per_sec"] = str(e)[:80]
    return row


def bench_multiproc(n_chains=8, iters=200, K=96, N=8, G=2000):
    """Measured cross-process chain-throughput: the same total work (8 chains
    at 96x2000, 200 iterations) run as 1 process vs split across 2
    jax.distributed processes (chains on the DCN axis, g inside one process
    — the no-collectives chain-dp layout). CPU gloo backend, 2 virtual
    devices per process.

    CAVEAT (same as bench_scaling): both processes share this host's
    physical cores, so the 2-process number is a lower bound — it measures
    core contention plus any cross-process overhead, not interconnect
    scaling. The chain-dp hot loop has zero collectives (compiled-HLO
    test), so the upper bound is linear."""
    import os
    import socket
    import subprocess
    import sys as _sys

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "_multihost_worker.py")
    repo = os.path.dirname(os.path.abspath(__file__))

    def run_procs(nprocs):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
        env["JAX_PLATFORMS"] = "cpu"
        procs = [
            subprocess.Popen(
                [_sys.executable, worker, str(pid), str(port), str(nprocs),
                 str(n_chains), str(iters), str(K), str(N), str(G),
                 "--bench"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=repo)
            for pid in range(nprocs)
        ]
        tps = None
        for p in procs:
            out, _ = p.communicate(timeout=900)
            if p.returncode != 0:
                raise RuntimeError(f"worker failed:\n{out}")
            for line in out.splitlines():
                if line.startswith("WORKER_TPS pid=0"):
                    tps = float(line.split("tps=")[1])
        return tps

    tps1 = run_procs(1)
    tps2 = run_procs(2)
    return [
        {"metric": f"multiproc_chain_iters_per_sec_{n_chains}chains_"
                   f"{K}x{G}_MH_1proc", "value": round(tps1, 2),
         "unit": "chain-iterations/sec", "vs_baseline": None},
        {"metric": f"multiproc_chain_iters_per_sec_{n_chains}chains_"
                   f"{K}x{G}_MH_2proc", "value": round(tps2, 2),
         "unit": "chain-iterations/sec", "vs_baseline": None,
         "scaling_vs_1proc": round(tps2 / tps1, 3)},
    ]


def bench_bic(ranks=range(1, 9), K=96, G=500):
    """Parallel vs serial min-BIC rank search wall-clock (warm programs).

    The parallel search runs every candidate rank as one vmapped device
    program (fixed per-chain inclusion masks — models/sampler.py::fit);
    the serial path is the reference's per-rank loop (bayesNMF.R:67-105).
    Both fit the same data with the same convergence control; wall-clock
    excludes first-compile (each mode is run twice, second timed).
    """
    import pandas as pd

    from bayesnmf_tpu.config import ConvergenceControl
    from bayesnmf_tpu.models.sampler import fit

    data = _sim_data(seed=0, K=K, N=4, G=G)
    cc = ConvergenceControl(MAP_over=200, MAP_every=100, miniters=400,
                            maxiters=800, Ninarow_nochange=3,
                            Ninarow_nobest=5)

    def run(parallel, seed):
        t0 = time.perf_counter()
        out = fit(data, list(ranks), likelihood="poisson",
                  prior="truncnormal", MH=True, rank_method="BIC",
                  convergence_control=cc, output_dir=None,
                  parallel_bic=parallel, seed=seed, post_warmup=200)
        return out, time.perf_counter() - t0

    run(True, 0)           # compile
    out_p, t_par = run(True, 1)
    run(False, 0)          # compile (all rank programs)
    out_s, t_ser = run(False, 1)
    assert out_p["best_rank"] == out_s["best_rank"], (
        out_p["best_rank"], out_s["best_rank"])
    return {"metric": f"bic_search_{len(list(ranks))}ranks_{K}x{G}_speedup",
            "value": round(t_ser / t_par, 2), "unit": "x vs serial loop",
            "vs_baseline": None,
            "parallel_seconds": round(t_par, 2),
            "serial_seconds": round(t_ser, 2),
            "best_rank": int(out_p["best_rank"])}


def bench_compaction(n_chains: int = 32):
    """Wall-clock of a staggered-convergence ensemble with live-chain
    compaction on vs off.

    Chains converge at different checks (per-chain RNG); with compact=False
    every finished chain keeps executing full Gibbs sweeps until the slowest
    one is done (the reference-shaped waste); compact=True shrinks the
    resident ensemble to power-of-two buckets of live chains. Both runs do
    identical statistical work (identical per-chain windows/MAPs)."""
    from bayesnmf_tpu.config import ConvergenceControl
    from bayesnmf_tpu.parallel.ensemble import ChainEnsemble

    data = _sim_data(seed=0, K=96, N=8, G=500)
    # tight tol + noisy no-best gate => chains converge at genuinely
    # different checks (measured spread ~650..3000 iters at these settings)
    cc = ConvergenceControl(MAP_over=100, MAP_every=50, miniters=200,
                            maxiters=3000, Ninarow_nochange=2,
                            Ninarow_nobest=6, tol=5e-5)

    def run(compact, seed):
        t0 = time.perf_counter()
        ens = ChainEnsemble(
            data, 8, n_chains=n_chains, likelihood="poisson",
            prior="truncnormal", MH=True, convergence_control=cc,
            post_warmup=200, seed=seed, output_dir=None, compact=compact,
            store_E=False, verbosity=0)
        ens.run()
        return ens, time.perf_counter() - t0

    # warm with the SAME seed so the timed run's bucket-size program
    # sequence is fully compiled (compile cost would otherwise swamp the
    # steady-state comparison)
    run(True, 1)
    ens_c, t_c = run(True, 1)
    run(False, 1)
    ens_n, t_n = run(False, 1)
    return {"metric": f"ensemble_compaction_{n_chains}chains_96x500",
            "value": round(t_n / t_c, 2), "unit": "x wall-clock speedup",
            "vs_baseline": None,
            "compact_seconds": round(t_c, 2),
            "no_compact_seconds": round(t_n, 2),
            "iters": int(ens_c.iter),
            "final_resident": int(ens_c._slots.size)}


def bench_chains(n_chains: int, iters: int = 100):
    """Multi-chain throughput (chain-iterations/sec) at config-2 size on
    the XLA sweep path."""
    import jax
    import jax.numpy as jnp

    from bayesnmf_tpu.config import ModelSpec, default_hyperprior_params
    from bayesnmf_tpu.parallel import chains as C

    data = _sim_data()
    spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson", prior="truncnormal",
                     MH=True)
    hp = default_hyperprior_params(spec, float(data.mean()))
    d = jnp.asarray(data)
    states = C.init_chain_states(spec, hp, d, jax.random.PRNGKey(0), n_chains)
    temps = jnp.ones((iters,), jnp.float32)
    acc = jnp.zeros((n_chains,), bool)
    states, _ = C.run_chunk_chains(spec, d, hp, states, temps, acc)
    jax.block_until_ready(states)
    t0 = time.perf_counter()
    states, _ = C.run_chunk_chains(spec, d, hp, states, temps, acc)
    jax.block_until_ready(states)
    dt = time.perf_counter() - t0
    return n_chains * iters / dt


def bench_scaling():
    """Chain-scaling table over mesh sizes on the current backend.

    Intended for the virtual CPU mesh (JAX_PLATFORMS=cpu +
    xla_force_host_platform_device_count=8): fixed chains-per-device, grow
    the chain axis; efficiency = aggregate / (n_dev x single-device).

    CAVEAT: virtual CPU devices share the host's physical cores, so this
    'efficiency' measures core contention, not interconnect scaling — it is
    a lower bound only. The real scaling argument is structural and tested:
    the compiled chain-dp hot loop contains ZERO collectives
    (test_parallel.py::test_chain_dp_hot_loop_has_no_collectives), so
    chain throughput on real multi-chip hardware scales linearly up to data
    replication; only the g axis communicates (psums between devices)."""
    import jax
    import jax.numpy as jnp

    from bayesnmf_tpu.config import ModelSpec, default_hyperprior_params
    from bayesnmf_tpu.parallel import chains as C
    from bayesnmf_tpu.parallel import mesh as M

    n_dev = len(jax.devices())
    per_dev = 4
    data = _sim_data(seed=0, K=96, N=8, G=200)
    spec = ModelSpec(K=96, N=8, G=200, likelihood="poisson",
                     prior="truncnormal", MH=True)
    hp = default_hyperprior_params(spec, float(data.mean()))
    d = jnp.asarray(data)
    iters = 30
    temps = jnp.ones((iters,), jnp.float32)
    rows = []
    base = None
    sizes = [s for s in (1, 2, 4, 8) if s <= n_dev]
    for nd in sizes:
        mesh = M.make_mesh(n_chain=nd, n_g=1,
                           devices=jax.devices()[:nd])
        n_chains = per_dev * nd
        init, run = C.make_sharded_chain_runner(spec, mesh, n_chains,
                                                record="metrics")
        states = init(hp, d, jax.random.PRNGKey(0))
        acc = jnp.zeros((n_chains,), bool)
        states, samples = run(d, hp, states, temps, acc)
        jax.block_until_ready(samples)
        t0 = time.perf_counter()
        states, samples = run(d, hp, states, temps, acc)
        jax.block_until_ready(samples)
        thr = n_chains * iters / (time.perf_counter() - t0)
        if base is None:
            base = thr
        rows.append({"devices": nd, "chains": n_chains,
                     "chain_iters_per_sec": round(thr, 2),
                     "efficiency": round(thr / (base * nd), 3)})
    return rows


def main():
    import sys

    from bayesnmf_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if "--chains" in sys.argv:
        n = int(sys.argv[sys.argv.index("--chains") + 1])
        cips = bench_chains(n)
        print(json.dumps({
            "metric": f"chain_iters_per_sec_{n}chains_96x500_K8_MH_xla",
            "value": round(cips, 2), "unit": "chain-iterations/sec/chip",
            "vs_baseline": None}))
        return
    if "--bic" in sys.argv:
        print(json.dumps(bench_bic()))
        return
    if "--compact" in sys.argv:
        print(json.dumps(bench_compaction()))
        return
    if "--scaling" in sys.argv:
        for row in bench_scaling():
            print(json.dumps(row))
        return
    if "--multiproc" in sys.argv:
        for row in bench_multiproc():
            print(json.dumps(row))
        return
    if "--all" in sys.argv:
        for fn in (config1, config2, config3, config4, config5):
            print(json.dumps(fn()))
        return
    if "--config" in sys.argv:
        n = int(sys.argv[sys.argv.index("--config") + 1])
        print(json.dumps(
            {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}[n]()))
        return
    # default (no args): ALL FIVE BASELINE configs, one JSON line each,
    # headline (config 2) first.
    for fn in (config2, config1, config3, config4, config5):
        try:
            print(json.dumps(fn()), flush=True)
        except Exception as e:  # one config failing must not hide the rest
            print(json.dumps({"metric": fn.__name__, "error": str(e)}),
                  flush=True)


if __name__ == "__main__":
    main()
