"""Fused latent-count multinomial allocation (the Poisson-Gibbs hot op).

The reference draws, for every cell (k, g), Z[k,:,g] ~ Multinomial(M[k,g],
p ∝ P[k,:]*A*E[:,g]) in a K*G R-level loop (sample_Zkg, sample_params.R:253-265)
— its dominant cost. Downstream only the two marginal sums are consumed
(sample_Pn.R:100-114 needs Σ_g Z[k,n,·]; sample_En.R:99-113 needs Σ_k Z[·,n,g]),
so the K×N×G tensor is materialized only transiently inside one fused program.

Design: **binary splitting** of the multinomial. A multinomial
over N components factorizes exactly into a balanced binary tree of
conditional binomials — Binomial(n, w_left/(w_left+w_right)) at every node —
so the whole draw needs only ceil(log2 N) *sequential* binomial launches,
each a single fully-batched (nodes, K, G) ``jax.random.binomial`` call on the
VPU. The previous design chained N-1 sequential (K, G) binomials; each call
pays the sampler's rejection/inversion while_loop latency, which profiling
showed dominated the conjugate-Gibbs iteration (905 of 971 µs at 96×100,
N=5). Depth-log2 batching cuts the sequential launches from N-1 to
ceil(log2 N) and makes each one wider.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from . import distributions as D


def allocate_counts(key, M, P, A, E):
    """Draw Z ~ Multinomial(M[k,g], probs ∝ P[k,:]*A*E[:,g]) per cell and
    return its marginal sums.

    Args:
      key: PRNG key.
      M: (K, G) observed counts (float32, integer-valued).
      P: (K, N) signatures; A: (N,) inclusion; E: (N, G) exposures.

    Returns:
      Zsum_g: (K, N) = Σ_g Z[k, n, g]
      Zsum_k: (N, G) = Σ_k Z[k, n, g]

    If all weights in a cell are zero the cell allocates all-zero counts,
    matching the reference's guard (sample_params.R:257-261). Components with
    zero weight (A_n = 0, or padding to the next power of two) receive
    exactly zero counts: their conditional split probability is exactly 0.
    """
    K, N = P.shape
    G = E.shape[1]
    PA = P * A[None, :]  # (K, N)

    # leaf weights w_n[k,g] = PA[k,n] * E[n,g], padded to a power of two
    n2 = 1 << max(int(math.ceil(math.log2(max(N, 1)))), 0)
    W = PA.T[:, :, None] * E[:, None, :]  # (N, K, G), exact f32 products
    if n2 > N:
        W = jnp.concatenate(
            [W, jnp.zeros((n2 - N, K, G), W.dtype)], axis=0)

    # bottom-up node weights: levels[l] has n2 >> l nodes
    levels = [W]
    while levels[-1].shape[0] > 1:
        w = levels[-1]
        levels.append(w[0::2] + w[1::2])

    # top-down counts: split each node's count between its two children with
    # one batched binomial per level (depth = log2(n2) sequential launches)
    counts = jnp.asarray(M, jnp.float32)[None]  # (1, K, G) at the root
    total = levels[-1][0]
    zero_cell = total <= 0.0
    counts = jnp.where(zero_cell[None], 0.0, counts)

    n_levels = len(levels) - 1
    # Distinct streams for the two consumers (threefry key-reuse
    # anti-pattern: split(key) shares bits with uniform(key)'s stream).
    keys = jax.random.split(jax.random.fold_in(key, 1), max(n_levels, 1))
    # ONE uniform launch covers every level of the conditional-binomial tree
    # (n2 - 1 internal nodes total); per-level slices index it by node offset.
    UNROLL = 8
    u_tree = jax.random.uniform(
        jax.random.fold_in(key, 0), (2 * UNROLL + 1, max(n2 - 1, 1), K, G),
        jnp.float32, minval=jnp.float32(1.2e-38))
    node_off = 0
    for li in range(n_levels - 1, -1, -1):
        w_child = levels[li]          # (2m, K, G)
        w_parent = levels[li + 1]     # (m, K, G)
        m_nodes = w_parent.shape[0]
        w_left = w_child[0::2]
        q = jnp.where(w_parent > 0.0,
                      w_left / jnp.maximum(w_parent, 1e-30), 0.0)
        q = jnp.clip(q, 0.0, 1.0)
        # Degenerate elements (q==0 from padding/excluded components, q==1,
        # or zero counts) must not reach the sampler: its internal
        # inversion/btrs math NaNs on the boundary and spins the rejection
        # while_loop to its cap — measured as a 12x slowdown. Feed them a
        # benign (n=0, q=0.5) draw and overwrite the result exactly.
        degen = (q <= 0.0) | (q >= 1.0) | (counts <= 0.0)
        q_call = jnp.where(degen, 0.5, q)
        n_call = jnp.where(degen, 0.0, counts)
        # ops.distributions.binomial_from_u: BTRS with unrolled candidates +
        # unrolled-inversion small regime (jax.random.binomial costs ~137
        # µs/call here and degrades 34x on >2-D shapes)
        left = D.binomial_from_u(
            u_tree[:, node_off:node_off + m_nodes], keys[li], n_call, q_call,
            unroll=UNROLL)
        node_off += m_nodes
        left = jnp.minimum(left, counts)
        left = jnp.where(q >= 1.0, counts, left)
        left = jnp.where((q <= 0.0) | (counts <= 0.0), 0.0, left)
        right = counts - left
        counts = jnp.stack([left, right], axis=1).reshape(
            -1, *counts.shape[1:])

    Z = counts[:N]  # (N, K, G) exact multinomial leaves
    return Z.sum(axis=2).T, Z.sum(axis=1)
