"""Tests of the fused multinomial latent-count allocation."""

import jax
import jax.numpy as jnp
import numpy as np

from bayesnmf_tpu.ops.allocation import allocate_counts


def setup(seed=0, K=6, N=4, G=8):
    rng = np.random.default_rng(seed)
    P = rng.gamma(2.0, 1.0, (K, N)).astype(np.float32)
    E = rng.gamma(2.0, 2.0, (N, G)).astype(np.float32)
    A = np.ones(N, np.float32)
    M = rng.poisson(P @ E).astype(np.float32)
    return M, P, A, E


def test_sums_conserve_counts():
    M, P, A, E = setup()
    Zg, Zk = allocate_counts(jax.random.PRNGKey(0), jnp.array(M), jnp.array(P),
                             jnp.array(A), jnp.array(E))
    Zg, Zk = np.asarray(Zg), np.asarray(Zk)
    total = M.sum()
    np.testing.assert_allclose(Zg.sum(), total, rtol=1e-6)
    np.testing.assert_allclose(Zk.sum(), total, rtol=1e-6)
    assert (Zg >= 0).all() and (Zk >= 0).all()


def test_excluded_component_gets_zero():
    M, P, A, E = setup()
    A[1] = 0.0
    Zg, Zk = allocate_counts(jax.random.PRNGKey(1), jnp.array(M), jnp.array(P),
                             jnp.array(A), jnp.array(E))
    assert np.asarray(Zg)[:, 1].sum() == 0
    assert np.asarray(Zk)[1, :].sum() == 0


def test_all_excluded_returns_zeros():
    M, P, A, E = setup()
    A[:] = 0.0
    Zg, Zk = allocate_counts(jax.random.PRNGKey(2), jnp.array(M), jnp.array(P),
                             jnp.array(A), jnp.array(E))
    assert np.asarray(Zg).sum() == 0 and np.asarray(Zk).sum() == 0


def test_marginal_means_match_multinomial():
    # E[Z_n sums] = sum over cells of M * p_n
    M, P, A, E = setup(3, K=4, N=3, G=5)
    M = M * 0 + 50.0  # fixed counts for tighter means
    W = np.einsum("kn,ng->kng", P, E)
    probs = W / W.sum(1, keepdims=True)
    want_Zg = np.einsum("kg,kng->kn", M, probs)

    reps = 300
    keys = jax.random.split(jax.random.PRNGKey(3), reps)
    f = jax.jit(lambda k: allocate_counts(k, jnp.array(M), jnp.array(P),
                                          jnp.array(A), jnp.array(E)))
    acc = np.zeros_like(want_Zg)
    for k in keys:
        Zg, _ = f(k)
        acc += np.asarray(Zg)
    got = acc / reps
    np.testing.assert_allclose(got, want_Zg, rtol=5e-2, atol=1.5)


def test_binomial_chain_variance_sane():
    # per-component variance should match multinomial variance n p (1-p)
    rng = np.random.default_rng(5)
    K, N, G = 1, 3, 1
    P = np.array([[0.2, 0.5, 0.3]], np.float32)
    E = np.ones((N, 1), np.float32)
    A = np.ones(N, np.float32)
    M = np.full((1, 1), 100.0, np.float32)
    reps = 2000
    keys = jax.random.split(jax.random.PRNGKey(6), reps)
    f = jax.jit(lambda k: allocate_counts(k, jnp.array(M), jnp.array(P),
                                          jnp.array(A), jnp.array(E)))
    samples = np.stack([np.asarray(f(k)[0])[0] for k in keys])  # (reps, N)
    p = np.array([0.2, 0.5, 0.3])
    np.testing.assert_allclose(samples.mean(0), 100 * p, rtol=3e-2)
    np.testing.assert_allclose(samples.var(0), 100 * p * (1 - p), rtol=1.5e-1)
