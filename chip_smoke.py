"""Smoke test of the sampler on one GPU: the main path through the public
entry points at real widths, every streaming kernel compiled for the card
against its plain reference, and a large-G ensemble.

    python chip_smoke.py          # phases A, B, C on one GPU
    python chip_smoke.py --four   # only the four-GPU mesh phases (D, E)

Phase A  ``bn.fit`` on 96x2780 Poisson counts from 6 Dirichlet signatures,
         Poisson-TruncNormal+MH with SBFI over ranks 1..10: the learned
         rank, MAP-P cosine to the truth, the MAP against a float64 NumPy
         mean of the same window, checkpoint save/load/resume, and no
         pandas or matplotlib on the fitting path.
Phase B  the six streaming kernels compiled for the card, vmapped over 8
         chains x 96x25,000 (N=8), against float64 NumPy sums; one
         stream_sweep_P/E against sweep_P/E at matched keys; the tests
         marked ``gpu``.
Phase C  ChainEnsemble, 64 chains x 96x25,000 with SBFI over ranks 1..8,
         default kernel choice (the streaming kernels on the GPU), two
         chunks, finite metric rows.
Phase D  (--four) a 4x1 chain mesh against the same ensemble on one card.
Phase E  (--four) a 1x4 G-sharded single fit at 96x25,000 against one card.

Every check raises on failure, so the process then exits non-zero and
prints no result. The last line of standard output is one JSON object
naming the device, printed only when every phase passed. Without a GPU the
script exits non-zero before any phase.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def simulate(K, N, G, seed):
    """Poisson counts from N Dirichlet signatures (K contexts) and
    Gamma(1.5, 1000) exposures over G genomes (about 9,000 mutations per
    genome at N=6, a whole-genome burden)."""
    rng = np.random.default_rng(seed)
    P = rng.dirichlet(np.full(K, 0.5), N).T
    E = rng.gamma(1.5, 1000.0, (N, G))
    return rng.poisson(P @ E).astype(np.float32), P


def matched_cosines(P_est, P_true):
    """Cosines of the estimated columns to the truth after Hungarian
    matching (one per matched pair)."""
    from scipy.optimize import linear_sum_assignment

    a = P_est / np.linalg.norm(P_est, axis=0, keepdims=True)
    b = P_true / np.linalg.norm(P_true, axis=0, keepdims=True)
    cos = a.T @ b
    rows, cols = linear_sum_assignment(-cos)
    return cos[rows, cols]


def _state_leaves(state):
    import jax

    return [np.asarray(x) for x in jax.tree.leaves(state)]


def phase_a(K=96, G=2780, n_true=6, max_rank=10, cc=None, post_warmup=300):
    """The main path: bn.fit with SBFI rank learning."""
    import bayesnmf_tpu as bn
    from bayesnmf_tpu.models.sampler import GibbsSampler

    M, P_true = simulate(K, n_true, G, seed=1)
    cc = cc or bn.ConvergenceControl(
        MAP_over=300, MAP_every=150, miniters=600, maxiters=1500,
        Ninarow_nochange=3, Ninarow_nobest=5)
    ranks = range(1, max_rank + 1)
    kw = dict(likelihood="poisson", prior="truncnormal", MH=True,
              rank_method="SBFI", convergence_control=cc,
              post_warmup=post_warmup, seed=0, verbosity=0)
    t0 = time.perf_counter()
    s = bn.fit(M, ranks, output_dir=None, **kw)
    log(f"A fit: {s.iter} iterations in {time.perf_counter() - t0:.2f} s "
        f"(compiles included), converged={s.tracker.converged}")

    keep = np.asarray(s.MAP["keep_sigs"])
    rank = int(keep.size)
    log(f"A learned rank: {rank} (truth {n_true})")
    assert rank == n_true, f"learned rank {rank} != {n_true}"
    cos = matched_cosines(np.asarray(s.MAP["P"], np.float64), P_true)
    log(f"A MAP-P matched cosines: min {cos.min():.4f}, "
        f"mean {cos.mean():.4f}")
    assert cos.min() >= 0.97, cos

    # the MAP against a float64 NumPy mean of the same window
    n = min(cc.MAP_over, s.iter)
    P_h, E_h, _ = s._gather_window(s.iter, n)
    mask = np.asarray(s.MAP["idx_mask"])
    P_h = np.asarray(P_h, np.float64)[mask]
    E_h = np.asarray(E_h, np.float64)[mask]
    tot = P_h.sum(axis=1, keepdims=True)
    tot = np.where(tot > 0, tot, 1.0)
    P_ref = (P_h / tot).mean(axis=0)[:, keep]
    E_ref = (E_h * np.swapaxes(tot, 1, 2)).mean(axis=0)[keep]
    for name, got, ref in (("P", s.MAP["P"], P_ref), ("E", s.MAP["E"], E_ref)):
        got = np.asarray(got, np.float64)
        err = np.max(np.abs(got - ref) / (np.abs(ref) + 1e-6 * np.abs(ref).max()))
        log(f"A MAP {name} vs float64 window mean: max rel err {err:.2e} "
            f"over {int(mask.sum())} samples")
        np.testing.assert_allclose(got, ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())

    # checkpoint after the first chunk, reload, resume to the end
    s2 = GibbsSampler(M, ranks, output_dir=None, **kw)
    s2._run_chunk(cc.MAP_every - 1, accept_all=True)
    s2._map_check()
    with tempfile.TemporaryDirectory() as d:
        s3 = GibbsSampler.load(s2.save_object(os.path.join(d, "s.ckpt")))
    for a, b in zip(_state_leaves(s2.state), _state_leaves(s3.state)):
        np.testing.assert_array_equal(a, b)
    s3.run_gibbs_sampler()
    same = (s3.iter == s.iter and all(
        np.array_equal(a, b)
        for a, b in zip(_state_leaves(s.state), _state_leaves(s3.state))))
    log(f"A resume: reload exact; resumed run bit-exact with the "
        f"uninterrupted one: {same} (iters {s3.iter} vs {s.iter})")

    heavy = [m for m in ("pandas", "matplotlib") if m in sys.modules]
    log(f"A heavy modules loaded by the fitting path: {heavy or 'none'}")
    assert not heavy, heavy
    return {"rank": rank, "min_cos": float(cos.min()), "resume_bitexact": same}


def phase_b(C=8, K=96, N=8, G=25000):
    """The streaming kernels compiled for the card against their references,
    then one matched-key stream sweep against the XLA sweep."""
    import jax
    import jax.numpy as jnp

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from stream_reference import check_kernels_vmapped

    from bayesnmf_tpu.config import ModelSpec, default_hyperprior_params
    from bayesnmf_tpu.models import updates as U
    from bayesnmf_tpu.ops import math as m
    from bayesnmf_tpu.ops import pallas_stream_sweeps as S
    from bayesnmf_tpu.parallel import chains as CH

    log(f"B geometry (Kp, Gt, tiles/block, blocks) at K={K}, G={G}: "
        f"{S.geometry(K, G)}, {S._NUM_WARPS} warps")
    t0 = time.perf_counter()
    times = check_kernels_vmapped(K=K, N=N, G=G, C=C)
    log(f"B six kernels x {C} chains x {K}x{G} match float64 sums "
        f"(rtol 1e-4 of sum|terms|) in {time.perf_counter() - t0:.1f} s; "
        "warm batched call ms: "
        + ", ".join(f"{k} {v * 1e3:.3f}" for k, v in times.items()))

    M, _ = simulate(K, 6, G, seed=2)
    data = jnp.asarray(M)
    spec = ModelSpec(K=K, N=N, G=G, likelihood="poisson",
                     prior="truncnormal", MH=True)
    hp = default_hyperprior_params(spec, float(M.mean()))
    st = CH.init_chain_states(spec, hp, data, jax.random.PRNGKey(3), C)
    params, prior = st["params"], st["prior"]
    keys = jax.random.split(jax.random.PRNGKey(4), C)

    def xla_P(p, pr, a, k):
        Mh = m.mhat(p["P"], p["A"], p["E"])
        return U.sweep_P(spec, data, p, pr, Mh, a, k, False)[0]

    def stream_P(p, pr, a, k):
        return U.stream_sweep_P(spec, data, p, pr, a, k, False)[0]

    def xla_E(p, pr, a, k):
        Mh = m.mhat(p["P"], p["A"], p["E"])
        return U.sweep_E(spec, data, p, pr, Mh, a, k, False)[0]

    def stream_E(p, pr, a, k):
        return U.stream_sweep_E(spec, data, p, pr, a, k, False)[0]

    # Rows of P (columns of E) are independent given E (P), so one flipped
    # decision changes only the later entries of its own row (column):
    # values are compared on the rows (columns) whose decisions all agree.
    acc_P = jnp.zeros((C, K, N))
    acc_E = jnp.zeros((C, N, G))
    for name, f_x, f_s, old, acc, sweep_axis in (
            ("P", xla_P, stream_P, params["P"], acc_P, 2),
            ("E", xla_E, stream_E, params["E"], acc_E, 1)):
        run = lambda f: np.asarray(jax.jit(jax.vmap(f))(  # noqa: E731
            params, prior, acc, keys))
        x, y, old = run(f_x), run(f_s), np.asarray(old)
        agree = (x != old) == (y != old)
        frac = float(agree.mean())
        same = np.broadcast_to(agree.all(axis=sweep_axis, keepdims=True),
                               agree.shape)
        scale = np.abs(x).max()
        err = np.abs(x[same] - y[same]) / (np.abs(x[same]) + 1e-6 * scale)
        log(f"B stream_sweep_{name} vs sweep_{name} at matched keys: "
            f"decisions agree {frac:.6f}, acceptance {(x != old).mean():.4f},"
            f" max rel diff on fully agreeing {'rows' if name == 'P' else 'columns'}"
            f" {err.max():.2e}")
        assert frac >= 0.999, frac
        np.testing.assert_allclose(y[same], x[same], rtol=1e-4,
                                   atol=1e-6 * scale)

    import pytest

    class _Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                _Count.passed += 1

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_stream_sweeps.py")],
                     plugins=[_Count()])
    log(f"B gpu-marked tests: exit {int(rc)}, {_Count.passed} passed")
    assert rc == 0 and _Count.passed > 0, rc
    return {"kernel_ms": {k: v * 1e3 for k, v in times.items()}}


def phase_c(C=64, K=96, N=8, G=25000, chunk=25):
    """A large-G rank-learning ensemble with the default kernel choice, two
    chunks."""
    import jax

    import bayesnmf_tpu as bn
    from bayesnmf_tpu.parallel.ensemble import ChainEnsemble

    M, _ = simulate(K, 6, G, seed=3)
    cc = bn.ConvergenceControl(MAP_over=chunk, MAP_every=chunk,
                               miniters=0, maxiters=2 * chunk)
    ens = ChainEnsemble(M, range(1, N + 1), n_chains=C, likelihood="poisson",
                        prior="truncnormal", MH=True, convergence_control=cc,
                        post_warmup=0, store_E=False, output_dir=None,
                        verbosity=0, seed=0)
    log(f"C ensemble {C} x {K}x{G}: stream_sweeps={ens.spec.stream_sweeps}")
    if jax.default_backend() == "gpu":
        assert ens.spec.stream_sweeps, "default selection skipped the kernels"
    t0 = time.perf_counter()
    ens.run()
    met = ens._metrics_all()
    live = ~np.isnan(met[..., 0])
    log(f"C ran to iter {ens.iter} in {time.perf_counter() - t0:.1f} s "
        f"(compiles included); metric rows {met.shape}, resident rows "
        f"{int(live.sum())}")
    assert ens.iter == 2 * chunk and live.any(axis=1).all()
    assert np.isfinite(met[live]).all(), "non-finite metric rows"
    return {}


def phase_d(C=8, K=96, N=8, G=2000, steps=9):
    """A 4x1 chain mesh against the same ensemble on one card (accept-all
    warmup chunk, so the chains follow continuous dynamics)."""
    from bayesnmf_tpu.parallel import mesh as Mm
    from bayesnmf_tpu.parallel.ensemble import ChainEnsemble

    M, _ = simulate(K, 6, G, seed=4)
    kw = dict(likelihood="poisson", prior="truncnormal", MH=True,
              stream_sweeps=False, store_E=False, output_dir=None,
              verbosity=0, seed=0)
    rows = {}
    for label, mesh in (("mesh", Mm.make_mesh(n_chain=4, n_g=1)),
                        ("one", None)):
        ens = ChainEnsemble(M, N, n_chains=C, mesh=mesh, **kw)
        t0 = time.perf_counter()
        ens._run_chunk(steps)
        rows[label] = ens._metrics_all()
        log(f"D {label}: {C} chains x {K}x{G}, {steps} iterations in "
            f"{time.perf_counter() - t0:.1f} s (compile included)")
    a, b = rows["mesh"][..., 1:5], rows["one"][..., 1:5]
    err = float(np.max(np.abs(a - b) / np.abs(b)))
    log(f"D per-chain metric rows (RMSE, KL, loglik, logpost), 4x1 mesh vs "
        f"one card: max rel diff {err:.2e}")
    np.testing.assert_allclose(a, b, rtol=1e-4)
    return {}


def phase_e(K=96, N=8, G=25000, steps=9):
    """A 1x4 G-sharded single fit against the same fit on one card: the
    first chunk's loglik trace."""
    import bayesnmf_tpu as bn
    from bayesnmf_tpu.models.sampler import GibbsSampler
    from bayesnmf_tpu.parallel import mesh as Mm

    M, _ = simulate(K, 6, G, seed=5)
    cc = bn.ConvergenceControl(MAP_over=steps + 1, MAP_every=steps + 1)
    ll = {}
    for label, mesh in (("mesh", Mm.make_mesh(n_chain=1, n_g=4)),
                        ("one", None)):
        s = GibbsSampler(M, N, likelihood="poisson", prior="truncnormal",
                         MH=True, convergence_control=cc, output_dir=None,
                         verbosity=0, seed=0, mesh=mesh)
        t0 = time.perf_counter()
        s._run_chunk(steps, accept_all=True)
        ll[label] = np.concatenate(s._metric_rows)[:, 3]
        log(f"E {label}: 96x{G} single fit, {steps} iterations in "
            f"{time.perf_counter() - t0:.1f} s (compile included)")
    err = float(np.max(np.abs(ll["mesh"] - ll["one"]) / np.abs(ll["one"])))
    log(f"E first-chunk loglik, 1x4 G-sharded vs one card: max rel diff "
        f"{err:.2e}")
    np.testing.assert_allclose(ll["mesh"], ll["one"], rtol=1e-4)
    return {}


def main(argv):
    four = "--four" in argv
    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        sys.exit(f"chip_smoke: needs a GPU; JAX runs on {backend!r}")
    devices = jax.devices()
    if four and len(devices) < 4:
        sys.exit(f"chip_smoke --four: needs 4 GPUs, found {len(devices)}")

    from bayesnmf_tpu.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    log(f"devices: {devices}")
    log(f"jax {jax.__version__}; compile cache: {cache}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()

    phases = ([("D", phase_d), ("E", phase_e)] if four
              else [("A", phase_a), ("B", phase_b), ("C", phase_c)])
    for name, fn in phases:
        t0 = time.perf_counter()
        fn()
        log(f"phase {name} passed in {time.perf_counter() - t0:.1f} s")

    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
