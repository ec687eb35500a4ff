"""Plain float64 NumPy references for the six streaming kernels
(bayesnmf_tpu/ops/pallas_stream_sweeps.py), shared by
tests/test_stream_sweeps.py and chip_smoke.py (Phase B)."""

import jax
import jax.numpy as jnp
import numpy as np

from bayesnmf_tpu.ops import pallas_stream_sweeps as S

KERNELS = ("pcol_stats", "pcol_accept", "erow_stats", "erow_accept",
           "acol_delta", "chain_metrics")


def kernel_inputs(K, N, G, seed=0):
    """Inputs of one chain: data drawn from its own P and E, the second
    column/row as the one updated, and proposals off the current values."""
    rng = np.random.default_rng(seed)
    PA = rng.gamma(2.0, 1.0, (K, N)).astype(np.float32)
    E = rng.gamma(2.0, 2.0, (N, G)).astype(np.float32)
    data = rng.poisson(PA @ E).astype(np.float32)
    n = min(1, N - 1)
    return dict(data=data, E=E, PA=PA, en=E[n], pn=PA[:, n],
                prop_k=(PA[:, n] * 1.3).astype(np.float32),
                prop_g=(E[n] * 0.7).astype(np.float32))


def call_kernel(name, x):
    """Run one kernel through its public wrapper; returns a tuple."""
    d, E, PA, en, pn = (jnp.asarray(x[k])
                        for k in ("data", "E", "PA", "en", "pn"))
    if name == "pcol_stats":
        return S.pcol_stats(d, E, PA, en, pn)
    if name == "pcol_accept":
        return S.pcol_accept(d, E, PA, en, pn, jnp.asarray(x["prop_k"]))
    if name == "erow_stats":
        return S.erow_stats(d, E, PA, en, pn)
    if name == "erow_accept":
        return S.erow_accept(d, E, PA, en, pn, jnp.asarray(x["prop_g"]))
    if name == "acol_delta":
        return (S.acol_delta(d, E, PA, en, pn, jnp.float32(1.0)),)
    return S.chain_metrics(d, E, PA)


def reference(name, x):
    """[(sum, sum of |terms|)] per output, in float64."""
    d, E, PA, en, pn = (np.asarray(x[k], np.float64)
                        for k in ("data", "E", "PA", "en", "pn"))
    fl = 1e-6
    Mh = PA @ E
    col, row = pn[:, None], en[None, :]
    if name == "pcol_stats":
        inv = 1.0 / np.maximum(Mh, fl)
        terms, axis = [(d - (Mh - col * row)) * inv * row, inv * row * row], 1
    elif name == "pcol_accept":
        Mh_no = Mh - col * row
        lam = np.maximum(Mh, fl)
        lam_new = np.maximum(Mh_no + x["prop_k"][:, None] * row, fl)
        dl, invr = lam_new - lam, 1.0 / lam_new
        terms = [d * np.log1p(dl / lam) - dl, (d - Mh_no) * invr * row,
                 invr * row * row]
        axis = 1
    elif name == "erow_stats":
        inv = 1.0 / np.maximum(Mh, fl)
        terms, axis = [(d - (Mh - col * row)) * inv * col, inv * col * col], 0
    elif name == "erow_accept":
        Mh_no = Mh - col * row
        lam = np.maximum(Mh, fl)
        lam_new = np.maximum(Mh_no + col * x["prop_g"][None, :], fl)
        dl, invr = lam_new - lam, 1.0 / lam_new
        terms = [d * np.log1p(dl / lam) - dl, (d - Mh_no) * invr * col,
                 invr * col * col]
        axis = 0
    elif name == "acol_delta":
        contrib = col * row
        lam_off = np.maximum(Mh - contrib, fl)
        dl = np.maximum(Mh, fl) - lam_off
        terms, axis = [d * np.log1p(dl / lam_off) - dl], None
    else:
        lam = np.maximum(Mh, fl)
        L = np.log(lam)
        terms = [d * L, lam, np.maximum(d, 1e-6) * L, (Mh - d) ** 2]
        axis = None
    return [(t.sum(axis), np.abs(t).sum(axis)) for t in terms]


def assert_matches_reference(name, x, got, rtol=1e-4):
    """Each output within rtol of the sum of |terms| (the summation order
    over G differs from the reference's)."""
    ref = reference(name, x)
    assert len(got) == len(ref)
    for g, (want, scale) in zip(got, ref):
        g = np.asarray(g, np.float64)
        assert g.shape == np.shape(want), (name, g.shape, np.shape(want))
        assert np.all(np.isfinite(g)), name
        np.testing.assert_array_less(np.abs(g - want), rtol * scale + 1e-6)


def check_kernels_vmapped(K, N, G, C, seed=0):
    """Every kernel vmapped over C chains with the data shared (the
    ensemble layout); each chain's outputs checked against its own
    reference. Returns {kernel: seconds of one warm batched call}."""
    import time

    xs = [kernel_inputs(K, N, G, seed=seed + c) for c in range(C)]
    data = jnp.asarray(xs[0]["data"])
    stacked = {k: jnp.stack([jnp.asarray(x[k]) for x in xs])
               for k in ("E", "PA", "en", "pn", "prop_k", "prop_g")}
    times = {}
    for name in KERNELS:
        fn = jax.jit(jax.vmap(
            lambda per_chain, d, name=name: call_kernel(
                name, {"data": d, **per_chain}), in_axes=(0, None)))
        outs = jax.block_until_ready(fn(stacked, data))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(stacked, data))
        times[name] = time.perf_counter() - t0
        for c in range(C):
            x = dict(xs[c], data=xs[0]["data"])
            assert_matches_reference(name, x, [o[c] for o in outs])
    return times
