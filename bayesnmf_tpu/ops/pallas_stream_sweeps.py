"""Streaming reductions for the large-G MH sweeps, as Pallas GPU kernels
(Triton route).

The XLA sweep path (models/updates.sweep_P/sweep_E) carries Mhat as device
state: every column update streams Mhat several times (sig, Mhat_no_n,
Mhat_prop, the final rank-1 update) on top of the data matrix. At ensemble
scale (64 chains x 96x25k: 614 MB per (C, K, G) tensor) that traffic is
the iteration's cost, and at 256 chains x 96x100k each such tensor is
9.8 GB.

These kernels never hold Mhat in device memory. Each block recomputes its
(K, Gt) Mhat tile in registers from P (K, N) and the E tile (N, Gt) as N
float32 FMAs (N is below the tensor-core contraction minimum, and FMAs keep
the product out of TF32) and emits only the conditional reductions:

  * P-column kernels (``pcol_*``) and the scalar kernels (``acol_delta``,
    ``chain_metrics``) reduce over G. Blocks run in parallel in no order, so
    each block loops over a few G tiles, writes one partial row, and a
    second pass (``jnp.sum`` in XLA) adds the partials.
  * E-row kernels (``erow_*``) reduce over K inside the block, so each
    block writes its own G columns and needs no second pass.

Rows are padded to a power of two (K=96 -> 128) and G tiles are powers of
two, as Triton requires; padded rows and columns load as zero and are
masked out of every sum they could reach.

The sampling math is identical to the exact-MH poisson branch of
updates.sweep_P/sweep_E (MH_Pn_poisson, sample_Pn.R:199-248, with the exact
TruncNormal Hastings correction); only the provider of the reductions
differs. tests/test_stream_sweeps.py pins the equivalence at matched keys.

The kernels compile for the GPU only. Elsewhere they run solely inside
``interpret_mode()`` (the Pallas interpreter, as the CPU tests use it);
any other call off the GPU raises.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_FLOOR = 1e-6   # MHAT_FLOOR (ops/math.py) as a python float for the kernel

#: Elements of one (rows, G-tile) block and the warps that run it: the
#: fastest geometry timed on an H100 at 64 chains x 96x25,000 (PERF.md,
#: PR 1; non-spilling geometries were within 20% of it).
_TILE_ELEMS = 4096
_NUM_WARPS = 8
#: Reduction kernels keep at least this many blocks per chain in flight
#: (more G tiles per block only when G is large).
_MIN_BLOCKS = 128
#: Largest K the kernels take: the row dimension is padded to a power of two
#: and a block holds all rows of a tile at least 16 columns wide.
MAX_K = _TILE_ELEMS // 16

_interpret = False


@contextlib.contextmanager
def interpret_mode():
    """Run the kernels in the Pallas interpreter while the context is open
    (CPU tests). Programs traced inside keep that choice in their cache."""
    global _interpret
    prev, _interpret = _interpret, True
    try:
        yield
    finally:
        _interpret = prev


def _use_interpret() -> bool:
    if _interpret:
        return True
    platform = jax.default_backend()
    if platform != "gpu":
        raise RuntimeError(
            "the streaming sweep kernels compile for the GPU only; this "
            f"process runs on {platform!r}. Use the XLA sweep path "
            "(stream_sweeps=False), or ops.pallas_stream_sweeps."
            "interpret_mode() to run them in the Pallas interpreter.")
    return False


def _pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def geometry(K: int, G: int):
    """(Kp, Gt, tiles_per_block, n_blocks) for a (K, G) problem: rows padded
    to a power of two, a power-of-two G tile of at most _TILE_ELEMS // Kp
    columns, and enough G tiles per block for the G-reducing kernels that
    each chain still has about _MIN_BLOCKS blocks."""
    if K > MAX_K:
        raise ValueError(f"streaming kernels take K <= {MAX_K}, got {K}")
    Kp = _pow2(K)
    Gt = max(16, min(_TILE_ELEMS // Kp, _pow2(G)))
    n_tiles = -(-G // Gt)
    per_block = max(1, n_tiles // _MIN_BLOCKS)
    return Kp, Gt, per_block, -(-n_tiles // per_block)


def _load_tile(data_ref, E_ref, PA_ref, g0, K, N, G, Kp, Gt):
    """Masked (Kp, Gt) data and Mhat tiles starting at column ``g0``, plus
    the row/column indices and masks."""
    rows = jnp.arange(Kp)
    cols = g0 + jnp.arange(Gt)
    rmask = rows < K
    cmask = cols < G
    m2 = rmask[:, None] & cmask[None, :]
    data = plgpu.load(data_ref.at[rows[:, None], cols[None, :]], mask=m2,
                      other=0.0)
    Mh = jnp.zeros((Kp, Gt), jnp.float32)
    for n in range(N):
        pa = plgpu.load(PA_ref.at[rows, n], mask=rmask, other=0.0)
        e = plgpu.load(E_ref.at[n, cols], mask=cmask, other=0.0)
        Mh = Mh + pa[:, None] * e[None, :]
    return data, Mh, rows, cols, rmask, cmask, m2


def _row_terms(kind, data, Mh, en, pns, props):
    """Per-element terms of the P-column reductions (summed over G).
    ``pns``/``props`` are A_n-pre-scaled (K, 1) columns, ``en`` the raw
    (1, Gt) exposure row (zero on padded columns, so every term is)."""
    if kind == "stats":
        inv = 1.0 / jnp.maximum(Mh, _FLOOR)
        resid = data - (Mh - pns * en)
        return resid * inv * en, inv * (en * en)
    Mh_no = Mh - pns * en
    lam = jnp.maximum(Mh, _FLOOR)
    lam_new = jnp.maximum(Mh_no + props * en, _FLOOR)
    d = lam_new - lam
    invr = 1.0 / lam_new
    return (data * jnp.log1p(d / lam) - d, (data - Mh_no) * invr * en,
            invr * (en * en))


def _pcol_kernel(kind, K, N, G, Kp, Gt, per_block, data_ref, E_ref, PA_ref,
                 en_ref, pn_ref, *rest):
    """P-column partial sums of one block over ``per_block`` G tiles."""
    if kind == "stats":
        prop_ref, outs = None, rest
    else:
        prop_ref, outs = rest[0], rest[1:]
    pid = pl.program_id(0)
    rows = jnp.arange(Kp)
    rmask = rows < K
    pns = plgpu.load(pn_ref.at[rows], mask=rmask, other=0.0)[:, None]
    props = (None if prop_ref is None else
             plgpu.load(prop_ref.at[rows], mask=rmask, other=0.0)[:, None])

    def tile(j, accs):
        g0 = (pid * per_block + j) * Gt
        data, Mh, _, cols, _, cmask, _ = _load_tile(
            data_ref, E_ref, PA_ref, g0, K, N, G, Kp, Gt)
        en = plgpu.load(en_ref.at[cols], mask=cmask, other=0.0)[None, :]
        terms = _row_terms(kind, data, Mh, en, pns, props)
        return tuple(a + t for a, t in zip(accs, terms))

    # elementwise accumulation across the block's tiles; one row sum at the
    # end instead of a cross-lane reduction per tile
    init = tuple(jnp.zeros((Kp, Gt), jnp.float32) for _ in outs)
    accs = (tile(0, init) if per_block == 1
            else jax.lax.fori_loop(0, per_block, tile, init))
    for o_ref, a in zip(outs, accs):
        plgpu.store(o_ref.at[pid, rows], jnp.sum(a, axis=1))


def _erow_kernel(kind, K, N, G, Kp, Gt, data_ref, E_ref, PA_ref, en_ref,
                 pn_ref, *rest):
    """E-row sums over K for one G tile. ``en`` (A_n * E_n) and ``prop``
    (A_n * proposal) are pre-scaled; ``pn`` stays raw (it is the weight).
    Padded rows load pn = 0, which zeroes every term."""
    if kind == "stats":
        prop_ref, outs = None, rest
    else:
        prop_ref, outs = rest[0], rest[1:]
    g0 = pl.program_id(0) * Gt
    data, Mh, rows, cols, rmask, cmask, _ = _load_tile(
        data_ref, E_ref, PA_ref, g0, K, N, G, Kp, Gt)
    ens = plgpu.load(en_ref.at[cols], mask=cmask, other=0.0)[None, :]
    pn = plgpu.load(pn_ref.at[rows], mask=rmask, other=0.0)[:, None]
    if kind == "stats":
        inv = 1.0 / jnp.maximum(Mh, _FLOOR)
        resid = data - (Mh - pn * ens)
        terms = (resid * inv * pn, inv * (pn * pn))
    else:
        props = plgpu.load(prop_ref.at[cols], mask=cmask, other=0.0)[None, :]
        Mh_no = Mh - pn * ens
        lam = jnp.maximum(Mh, _FLOOR)
        lam_new = jnp.maximum(Mh_no + pn * props, _FLOOR)
        d = lam_new - lam
        invr = 1.0 / lam_new
        terms = (data * jnp.log1p(d / lam) - d, (data - Mh_no) * invr * pn,
                 invr * (pn * pn))
    for o_ref, t in zip(outs, terms):
        plgpu.store(o_ref.at[cols], jnp.sum(t, axis=0), mask=cmask)


def _scalar_kernel(kind, K, N, G, Kp, Gt, per_block, data_ref, E_ref, PA_ref,
                   *rest):
    """Scalar partial sums of one block: the inclusion-sweep loglik delta
    (``acol``) or the four data-dependent metric sums (``metrics``)."""
    if kind == "acol":
        en_ref, pn_ref, an_ref, outs = rest[0], rest[1], rest[2], rest[3:]
        rows = jnp.arange(Kp)
        pn = plgpu.load(pn_ref.at[rows], mask=rows < K, other=0.0)[:, None]
        an = an_ref[0]
    else:
        outs = rest
    pid = pl.program_id(0)

    def tile(j, accs):
        g0 = (pid * per_block + j) * Gt
        data, Mh, _, cols, _, cmask, m2 = _load_tile(
            data_ref, E_ref, PA_ref, g0, K, N, G, Kp, Gt)
        if kind == "acol":
            # sample_An (sample_params.R:101-166): padded entries have
            # contrib = 0, so d = 0 there
            en = plgpu.load(en_ref.at[cols], mask=cmask, other=0.0)[None, :]
            contrib = pn * en
            Mh_off = Mh - an * contrib
            lam_off = jnp.maximum(Mh_off, _FLOOR)
            d = jnp.maximum(Mh_off + contrib, _FLOOR) - lam_off
            terms = (data * jnp.log1p(d / lam_off) - d,)
        else:
            # poisson loglik, padded KL and RMSE sums (ops/math.py); the
            # floors make padded entries nonzero, so those terms are masked
            lam = jnp.maximum(Mh, _FLOOR)
            L = jnp.log(lam)
            dd = Mh - data
            terms = (data * L, jnp.where(m2, lam, 0.0),
                     jnp.where(m2, jnp.maximum(data, 1e-6) * L, 0.0), dd * dd)
        return tuple(a + t for a, t in zip(accs, terms))

    init = tuple(jnp.zeros((Kp, Gt), jnp.float32) for _ in outs)
    accs = (tile(0, init) if per_block == 1
            else jax.lax.fori_loop(0, per_block, tile, init))
    for o_ref, a in zip(outs, accs):
        o_ref[pid] = jnp.sum(a)


_N_OUT = {("pcol", "stats"): 2, ("pcol", "accept"): 3,
          ("erow", "stats"): 2, ("erow", "accept"): 3,
          ("scalar", "acol"): 1, ("scalar", "metrics"): 4}


@functools.partial(jax.jit, static_argnames=(
    "family", "kind", "geom", "num_warps", "interpret"))
def _call(args, *, family, kind, geom, num_warps, interpret):
    data, E, PA = args[:3]
    K, N = PA.shape
    G = E.shape[1]
    Kp, Gt, per_block, n_blocks = geom
    n_out = _N_OUT[(family, kind)]
    if family == "pcol":
        kern = functools.partial(_pcol_kernel, kind, K, N, G, Kp, Gt,
                                 per_block)
        grid, oshape = n_blocks, (n_blocks, Kp)
    elif family == "erow":
        kern = functools.partial(_erow_kernel, kind, K, N, G, Kp, Gt)
        grid, oshape = -(-G // Gt), (G,)
    else:
        kern = functools.partial(_scalar_kernel, kind, K, N, G, Kp, Gt,
                                 per_block)
        grid, oshape = n_blocks, (n_blocks,)
    res = pl.pallas_call(
        kern,
        grid=(grid,),
        out_shape=[jax.ShapeDtypeStruct(oshape, jnp.float32)] * n_out,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name=f"stream_{family}_{kind}",
    )(*args)
    if family == "pcol":
        return tuple(jnp.sum(r, axis=0)[:K] for r in res)
    if family == "scalar":
        return tuple(jnp.sum(r) for r in res)
    return tuple(res)


def _run(family, kind, *args):
    K = args[2].shape[0]
    G = args[1].shape[1]
    return _call(args, family=family, kind=kind, geom=geometry(K, G),
                 num_warps=_NUM_WARPS, interpret=_use_interpret())


# Pre-scaling contract (the A_n multiply never reaches the per-element
# work): P-column kernels take pn = A_n*P_n and prop = A_n*proposal with en
# raw; E-row kernels take en = A_n*E_n and prop = A_n*proposal with pn raw.

def pcol_stats(data, E, PA, en, pn_scaled):
    """Forward-conditional sums of one P column, each (K,):
    mu1 = sum_g (data - Mhat_no_n) / sig * E_n, den = sum_g E_n^2 / sig."""
    return _run("pcol", "stats", data, E, PA, en, pn_scaled)


def pcol_accept(data, E, PA, en, pn_scaled, prop_scaled):
    """Acceptance sums of one P column, each (K,): the Poisson delta-loglik
    row sum and the reverse-conditional mu1/den (sig_r = max(Mhat_prop,
    floor))."""
    return _run("pcol", "accept", data, E, PA, en, pn_scaled, prop_scaled)


def erow_stats(data, E, PA, en_scaled, pn):
    """Forward-conditional sums of one E row, each (G,)."""
    return _run("erow", "stats", data, E, PA, en_scaled, pn)


def erow_accept(data, E, PA, en_scaled, pn, prop_scaled):
    """Acceptance sums of one E row, each (G,)."""
    return _run("erow", "accept", data, E, PA, en_scaled, pn, prop_scaled)


def acol_delta(data, E, PA, en, pn, an):
    """loglik(A_n=1) - loglik(A_n=0) for one inclusion column."""
    return _run("scalar", "acol", data, E, PA, en, pn,
                jnp.reshape(an, (1,)).astype(jnp.float32))[0]


def chain_metrics(data, E, PA):
    """(sum M log lam, sum lam, sum Mp log lam, sum (Mhat-M)^2) for one
    chain, streaming data + E once. vmap over chains for ensembles."""
    return _run("scalar", "metrics", data, E, PA)
