"""MAP inference over the posterior sample window: mode-of-A, renormalized
elementwise means, credible intervals.

Parity: get_MAP_ (utils.R:194-288) + get_mode (helpers.R:63-79). The binary-A
mode is found by bit-packing each A sample (replacing the reference's
string-hash of matrices) on the small (S, N) host array; the heavy P/E
averaging and quantiles run as TWO jitted mask-weighted device programs with
shapes fixed by the window size — no per-check recompiles, no eager dispatch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import math as m

# window means are contractions over samples: keep them out of TF32
_HIGHEST = jax.lax.Precision.HIGHEST


def a_mode(A_hist: np.ndarray):
    """Mode of the binary inclusion samples.

    Args:
      A_hist: (S, N) 0/1 array (host numpy).
    Returns: (mode_vector (N,), match_mask (S,), top_counts list[(pattern, count)])
    """
    Ab = np.asarray(A_hist).astype(np.int8)
    uniq, inverse, counts = np.unique(
        Ab, axis=0, return_inverse=True, return_counts=True
    )
    order = np.argsort(-counts)
    mode_row = uniq[order[0]]
    mask = inverse == order[0]
    top = [
        ("".join(str(int(v)) for v in uniq[i]), int(counts[i]))
        for i in order[:5]
    ]
    return mode_row.astype(np.float32), mask, top


@jax.jit
def _masked_renorm_mean_P(P_hist, mask):
    """P-only variant for runs that discarded the E history (store_E=False)."""
    w = mask.astype(jnp.float32)
    w = w / jnp.maximum(jnp.sum(w), 1.0)
    s = jnp.sum(P_hist, axis=1, keepdims=True)
    safe = jnp.where(s > 0, s, 1.0)
    P_rn = P_hist / safe
    return jnp.einsum("s,skn->kn", w, P_rn, precision=_HIGHEST), P_rn


@jax.jit
def _masked_renorm_mean(P_hist, E_hist, mask):
    """Mask-weighted mean of per-sample renormalized (P, E).

    Renormalization is per-column independent (helpers.R:35-49), so running
    it over all N columns then subsetting afterwards equals the reference's
    renormalize-then-subset order.
    """
    w = mask.astype(jnp.float32)
    w = w / jnp.maximum(jnp.sum(w), 1.0)
    s = jnp.sum(P_hist, axis=1, keepdims=True)            # (S, 1, N)
    safe = jnp.where(s > 0, s, 1.0)
    P_rn = P_hist / safe
    E_rn = E_hist * jnp.swapaxes(safe, 1, 2)
    P_map = jnp.einsum("s,skn->kn", w, P_rn, precision=_HIGHEST)
    E_map = jnp.einsum("s,sng->ng", w, E_rn, precision=_HIGHEST)
    return P_map, E_map, P_rn, E_rn


@partial(jax.jit, static_argnames=("lo",))
def _masked_quantiles(X, mask, lo: float):
    """Elementwise (lo, 1-lo) quantiles over the masked leading axis.

    Masked-out samples sort to +inf; quantile positions index only the first
    n_valid entries (linear interpolation, matching R's default type-7 like
    jnp.quantile).
    """
    S = X.shape[0]
    big = jnp.where(mask.reshape((S,) + (1,) * (X.ndim - 1)), X, jnp.inf)
    srt = jnp.sort(big, axis=0)
    n = jnp.sum(mask).astype(jnp.float32)

    def q_at(q):
        pos = q * (n - 1.0)
        i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, S - 1)
        i1 = jnp.clip(i0 + 1, 0, S - 1)
        frac = pos - i0.astype(jnp.float32)
        x0 = jnp.take(srt, i0, axis=0)
        x1 = jnp.take(srt, jnp.minimum(i1, jnp.sum(mask).astype(jnp.int32) - 1),
                      axis=0)
        return x0 * (1.0 - frac) + x1 * frac

    return q_at(jnp.float32(lo)), q_at(jnp.float32(1.0 - lo))


def compute_map(P_hist, E_hist, A_hist, final: bool, credible_interval=0.95,
                want_ci: bool = True):
    """Compute the MAP estimate (and CIs) from a window of posterior samples.

    Steps (get_MAP_, utils.R:200-288): (i) mode of A; (ii) weight samples
    matching the mode; (iii) renormalize each so P columns sum to 1 scaling E
    up; (iv) elementwise mean → MAP P/E; CIs = elementwise quantiles.

    Args:
      P_hist: (S, K, N); E_hist: (S, N, G) or None if the E history was not
        retained (ChainEnsemble store_E=False) — the result then carries no
        'E' key (and no E credible intervals) rather than a fabricated one;
      A_hist: (S, N) — device or host.
      final: subset to included signatures (keep_sigs) if True.
    Returns dict with P, E, A, keep_sigs, idx_mask, A_counts, and optionally
    credible_intervals {P: {lower, upper}, E: {lower, upper}}.
    """
    A_host = np.asarray(A_hist)
    mode_row, mask, top = a_mode(A_host)

    if final:
        keep_sigs = np.nonzero(mode_row == 1)[0]
        if keep_sigs.size == 0:
            keep_sigs = np.arange(mode_row.shape[0])
    else:
        keep_sigs = np.arange(mode_row.shape[0])

    mask_d = jnp.asarray(mask)
    P_hist = jnp.asarray(P_hist)
    if E_hist is None:
        P_map, P_rn = _masked_renorm_mean_P(P_hist, mask_d)
        E_map = E_rn = None
    else:
        E_hist = jnp.asarray(E_hist)
        P_map, E_map, P_rn, E_rn = _masked_renorm_mean(P_hist, E_hist, mask_d)

    out = {
        "P": P_map[:, keep_sigs],
        "A": mode_row[keep_sigs],
        "A_full": mode_row,
        "keep_sigs": keep_sigs,
        "idx_mask": mask,
        "A_counts": top,
    }
    if E_map is not None:
        out["E"] = E_map[keep_sigs, :]
    if want_ci:
        lo = float((1.0 - credible_interval) / 2.0)
        P_lo, P_hi = _masked_quantiles(P_rn, mask_d, lo)
        out["credible_intervals"] = {
            "P": {"lower": P_lo[:, keep_sigs], "upper": P_hi[:, keep_sigs]},
        }
        if E_rn is not None:
            E_lo, E_hi = _masked_quantiles(E_rn, mask_d, lo)
            out["credible_intervals"]["E"] = {
                "lower": E_lo[keep_sigs, :], "upper": E_hi[keep_sigs, :]}
    return out


@jax.jit
def _map_quality(data, P, E):
    Mh = m.dot_f32(P, E)
    return m.rmse(data, Mh), m.padded_kl(Mh, data)


def map_quality_metrics(data, map_est, G: int, K: int):
    """RMSE/KL/n_params/BIC-shape metrics of a MAP estimate.

    Parity: compute_metrics_ with final A recoded to ones (utils.R:419-423):
    the MAP P/E are already filtered/renormalized, so Mhat = P @ E.
    """
    rmse_v, kl_v = _map_quality(data, map_est["P"], map_est["E"])
    rank = float(np.sum(np.asarray(map_est["A_full"])))
    return {
        "RMSE": float(np.asarray(rmse_v)),
        "KL": float(np.asarray(kl_v)),
        "n_params": rank * (G + K),
        "rank": rank,
    }
