"""Multi-chain ensemble driver: many independent chains, one device program.

No reference equivalent (the R package runs exactly one chain,
advanced.qmd:56). Chains are vmapped into a single jitted chunk program
(parallel/chains.py), optionally sharded over a (chain, g) mesh. Each chain
keeps reference semantics individually: warmup with accept-all MH until its
own convergence, then ``post_warmup`` true-MH inference samples; per-chain
convergence is tracked host-side from the vectorized metric outputs.

First-class driver features (same surface as models/sampler.GibbsSampler):
logging to ``output_dir/log.txt``, periodic checkpoint + bit-exact resume
(utils/checkpoint.py), hyperprior/init overrides (bayesNMF.R:35-37 contract),
full posterior histories (``record_history='full'``), per-chain credible
intervals, and postprocessing entry points — per-chain COSMIC assignment via
the same cosine-weighted Hungarian voting the single-chain path uses
(postprocessing.R:175-341) plus pooled cross-chain summaries.

Two throughput mechanisms the single-chain path lacks:
  - the streaming sweep kernels (ops/pallas_stream_sweeps), chosen for
    large poisson+MH ensembles on the GPU (``_auto_stream_sweeps``): no
    (chains, K, G) tensor is held in device memory;
  - **live-chain compaction**: once a chain has finished its inference window
    (its ``_end_iter``), its MAP/CIs/sample window are finalized to host
    memory and the device ensemble is compacted to the still-running chains
    (power-of-two buckets, so at most log2(C) program sizes ever compile) —
    converged chains stop consuming device iterations instead of idling
    until the slowest chain finishes (bench.py --compact).
"""

from __future__ import annotations

import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    ConvergenceControl,
    ModelSpec,
    default_MH,
    default_hyperprior_params,
)
from ..models import gibbs
from ..models.convergence import VectorConvergenceTracker
from ..models.map_estimate import compute_map
from ..utils.logging import RunLogger
from . import chains as chains_mod


#: Smallest G at which the streaming sweep kernels beat the XLA sweep path
#: for rank-learning (SBFI/BFI) ensembles. Measured on one H100 at 64 chains
#: (PERF.md, PR 1): the kernels lose at G = 2,000 and 8,000 and win at
#: 25,000 and at 256 chains x 100,000. With a fixed rank they lost at every
#: G up to 25,000, so there they serve only shapes the XLA path cannot fit.
_STREAM_SWEEPS_MIN_G = 25000
#: Peak device bytes of the XLA sweep path per element of a (chains, K, G)
#: tensor: 32.8 GB at 256 chains x 96x100,000 SBFI on an H100 (PERF.md,
#: PR 1). The streaming path needed 4.0 bytes per element there.
_XLA_BYTES_PER_CKG = 13.4


def _auto_stream_sweeps(likelihood, prior, MH, mesh, learning_rank, C, K, G,
                        platform=None, bytes_limit=None):
    """Default for the streaming sweep kernels (ops/pallas_stream_sweeps):
    poisson+MH ensembles on the GPU, at a K the kernels take, that either
    learn the rank at large G (where the kernels are faster) or would not
    fit in device memory on the XLA path. Mesh-sharded runs keep the XLA
    path (pallas_call under GSPMD partitioning of the G axis is not
    supported)."""
    from ..ops.pallas_stream_sweeps import MAX_K

    platform = platform or jax.default_backend()
    if not (likelihood == "poisson" and bool(MH)
            and prior in ("truncnormal", "exponential")
            and mesh is None and platform == "gpu" and K <= MAX_K):
        return False
    if learning_rank and G >= _STREAM_SWEEPS_MIN_G:
        return True
    if bytes_limit is None:
        bytes_limit = jax.devices()[0].memory_stats()["bytes_limit"]
    return _XLA_BYTES_PER_CKG * C * K * G > bytes_limit


class _ViewTracker:
    """Per-chain convergence facts for a _ChainView (summarize_samplers and
    the trace plots read ``.converged`` / ``.converged_iter`` / ``.why``)."""

    def __init__(self, ens: "ChainEnsemble", chain: int):
        self._ens = ens
        self._c = chain

    @property
    def converged(self):
        return bool(self._ens.tracker.converged[self._c])

    @property
    def converged_iter(self):
        it = int(self._ens.tracker.converged_iter[self._c])
        return it if it >= 0 else None

    @property
    def why(self):
        return self._ens.tracker.why(self._c)


class _ChainView:
    """Single-chain adapter over an ensemble: exposes the GibbsSampler
    surface the shared postprocessing + plotting machinery consumes (spec,
    data, MAP, credible_intervals, samples, sample_metrics, _gather_window,
    reference_comparison), so ``plot_sig(fit(...)["sampler"], 1)`` etc. work
    on the parallel-BIC result exactly as on a serial fit
    (bayesNMF.R:117-126 returns the winner's full sampler)."""

    def __init__(self, ensemble: "ChainEnsemble", chain: int):
        self._ens = ensemble
        self.chain = chain
        self.spec = ensemble.spec
        self.cc = ensemble.cc
        self.row_names = getattr(ensemble, "row_names", None)
        self.col_names = getattr(ensemble, "col_names", None)
        self.temp_sched = ensemble.temp_sched
        self.tracker = _ViewTracker(ensemble, chain)

    @property
    def MAP_metrics(self):
        """Per-convergence-check MAP-metric rows for this chain, built by the
        ensemble's ``_check_convergence`` from the vectorized metrics — the
        returned-sampler contract of the reference (bayesNMF.R:117-126;
        update_MAP_metrics_, utils.R:356-397). ``trace_plot(MAP_means=True)``
        renders these directly."""
        return self._ens._MAP_metrics_per_chain[self.chain]

    @property
    def _archive(self):
        """Full per-chain sample archive (``save_all_samples=True`` on the
        ensemble): every recorded chunk, restricted to this chain, in the
        single-chain archive format ``_gather_window``/``samples`` consume.
        None when the ensemble keeps only the retained window."""
        arch = self._ens._archive
        if arch is None:
            return None
        out = []
        for ch in arch:
            pos = np.nonzero(ch["chain_ids"] == self.chain)[0]
            if pos.size == 0:
                continue
            s = int(pos[0])
            out.append({
                k: (v if k == "start_iter"
                    else jax.tree.map(lambda x: x[s], v))
                for k, v in ch.items() if k != "chain_ids"})
        return out

    # -- MAP ------------------------------------------------------------

    @property
    def MAP(self):
        return self._ens.MAP_per_chain[self.chain]

    @MAP.setter
    def MAP(self, value):
        self._ens.MAP_per_chain[self.chain] = value

    @property
    def credible_intervals(self):
        m = self.MAP
        return m.get("credible_intervals") if m else None

    def get_MAP(self, end_iter=None, n_samples=None, final=True,
                credible_interval=0.95):
        """(Re)compute this chain's MAP over an arbitrary window — honoring
        the reference's get_MAP(end_iter=, n_samples=) contract
        (utils.R:194-212); with no arguments returns the finalized MAP."""
        if end_iter is None and n_samples is None and self.MAP is not None:
            return self.MAP
        end = self._end_default() if end_iter is None else int(end_iter)
        n = min(n_samples or self._ens.cc.MAP_over, end)
        P_h, E_h, A_h = self._gather_window(end, n)
        res = compute_map(P_h, E_h, A_h, final=final,
                          credible_interval=credible_interval,
                          want_ci=self._ens.want_ci)
        res["idx"] = np.arange(end - A_h.shape[0] + 1, end + 1)[
            res["idx_mask"]]
        res["sig_idx"] = np.arange(len(res["keep_sigs"]))
        self.MAP = res
        return res

    def _end_default(self):
        e = int(self._ens._end_iter[self.chain])
        return e if 0 < e <= self._ens.iter else self._ens.iter

    @property
    def iter(self):
        """Last iteration of this chain's inference phase (the run-end for
        phase brackets in trace plots)."""
        return self._end_default()

    # -- shared postprocessing plumbing ---------------------------------

    @property
    def reference_comparison(self):
        """Memoization lives on the ensemble so it survives view churn."""
        return self._ens._reference_comparisons.setdefault(self.chain, {})

    @reference_comparison.setter
    def reference_comparison(self, value):
        self._ens._reference_comparisons[self.chain] = value

    @property
    def data(self):
        return self._ens.data

    @property
    def output_dir(self):
        return self._ens.output_dir

    @property
    def time(self):
        return self._ens.time

    @property
    def sample_metrics(self):
        """This chain's per-iteration metrics as a DataFrame
        (sample_metrics, bayesNMF_sampler.R:190-207). Iterations run after
        the chain was compacted away are absent (NaN rows dropped)."""
        import pandas as pd

        rows = self._ens._metrics_all()[self.chain]  # (T, m)
        rows = rows[~np.isnan(rows[:, 0])]
        return pd.DataFrame(rows, columns=list(gibbs.METRIC_NAMES))

    @property
    def samples(self):
        """This chain's retained sample window as {name: (S, ...)} arrays
        (P/E/A always; prior params, sigmasq and acceptance histories too
        under ``record_history='full'`` — bayesNMF_sampler.R:651-672)."""
        fin = self._ens._final_windows.get(self.chain)
        if fin is not None:
            return {k: v for k, v in fin.items() if k != "end_iter"}
        out: dict = {}
        for ch in self._ens._window:
            pos = np.nonzero(ch["chain_ids"] == self.chain)[0]
            if pos.size == 0:
                continue
            s = int(pos[0])
            for k, v in ch.items():
                if k in ("start_iter", "chain_ids"):
                    continue
                if isinstance(v, dict):  # prior-param subtree
                    for pk, pv in v.items():
                        out.setdefault(pk, []).append(np.asarray(pv[s]))
                else:
                    out.setdefault(k, []).append(np.asarray(v[s]))
        if not out:
            raise ValueError("no retained samples for this chain")
        return {k: np.concatenate(v) for k, v in out.items()}

    def assign_signatures_ensemble(self, reference_P="cosmic", idxs=None,
                                   credible_interval=0.95):
        from ..utils.postprocessing import assign_signatures_ensemble

        return assign_signatures_ensemble(
            self, reference_P=reference_P, idxs=idxs,
            credible_interval=credible_interval)

    def summary(self, reference_P="cosmic"):
        from ..utils.postprocessing import sampler_summary

        return sampler_summary(self, reference_P=reference_P)

    def save_object(self, path: Optional[str] = None):
        return self._ens.save_object(path)

    # -- model math conveniences (parity with the serial sampler's R6
    #    public surface, bayesNMF_sampler.R:8-541) ----------------------

    def _live_slot(self):
        pos = np.nonzero(self._ens._slots == self.chain)[0]
        return int(pos[0]) if pos.size else None

    def _current(self, group: str = "params") -> dict:
        """Latest parameter values for this chain: the live device state
        while resident, else the last recorded draw of its finalized
        window (prior params need ``record_history='full'`` there)."""
        s = self._live_slot()
        if s is not None:
            return {k: np.asarray(v[s])
                    for k, v in self._ens.states[group].items()}
        fin = self._ens._final_windows.get(self.chain)
        if fin is None:
            raise ValueError(
                f"chain {self.chain} has no live state or finalized window")
        if group == "params":
            out = {"P": fin["P"][-1], "A": fin["A"][-1]}
            for k in ("E", "sigmasq"):
                if k in fin:
                    out[k] = fin[k][-1]
            return out
        names = list(self._ens.states[group].keys())
        if all(k in fin for k in names):
            return {k: fin[k][-1] for k in names}
        raise ValueError(
            "prior params of a compacted chain are only recorded under "
            "record_history='full'")

    def get_Mhat(self, P=None, A=None, E=None):
        from ..ops import math as m

        p = self._current()
        if E is None and "E" not in p:
            raise ValueError(
                "exposures not retained for this chain: rerun with "
                "store_E=True or pass E explicitly")
        return m.mhat(
            jnp.asarray(P if P is not None else p["P"]),
            jnp.asarray(A if A is not None else p["A"]),
            jnp.asarray(E if E is not None else p["E"]),
        )

    def get_loglik(self, P=None, A=None, E=None, sigmasq=None,
                   likelihood=None, return_matrix=False):
        from ..ops import math as m

        Mh = self.get_Mhat(P, A, E)
        lik = likelihood or self.spec.likelihood
        sq = sigmasq
        if sq is None and self.spec.needs_sigmasq:
            sq = self._current().get("sigmasq")
        mat = m.loglik_mat(self.data, Mh, lik,
                           jnp.asarray(sq) if sq is not None else None)
        return mat if return_matrix else jnp.sum(mat)

    def get_logpost(self, P=None, A=None, E=None, sigmasq=None):
        from ..ops import math as m

        p = self._current()
        prior = self._current("prior")
        ll = self.get_loglik(P, A, E, sigmasq)
        return ll + m.logprior_PE(
            jnp.asarray(P if P is not None else p["P"]),
            jnp.asarray(E if E is not None else p["E"]),
            self.spec.prior,
            {k: jnp.asarray(v) for k, v in prior.items()},
        )

    def _gather_window(self, end_iter: int, n_samples: int):
        """Stack this chain's last ``n_samples`` samples ending at
        ``end_iter`` (finalized host window if it covers the request, live
        device chunks else; the full archive serves far-past windows when the
        ensemble was run with ``save_all_samples=True`` — the reference's
        get_MAP(end_iter=) contract over all history, utils.R:194-212)."""
        lo = end_iter - n_samples + 1
        c = self.chain
        fin = self._ens._final_windows.get(c)
        if fin is not None:
            fe = fin["end_iter"]
            S = fin["A"].shape[0]
            covers = lo >= fe - S + 1 and end_iter <= fe
            if covers or self._archive is None:
                i0 = max(S - (fe - lo + 1), 0)
                i1 = min(S - (fe - end_iter), S)
                if i1 > i0:
                    E = fin.get("E")
                    return (jnp.asarray(fin["P"][i0:i1]),
                            jnp.asarray(E[i0:i1]) if E is not None else None,
                            np.asarray(fin["A"][i0:i1]))
        # per-chain chunk list: live retained window, or the archive when
        # the request starts before the retained coverage
        chunks = []
        for ch in self._ens._window:
            pos = np.nonzero(ch["chain_ids"] == c)[0]
            if pos.size == 0:
                continue
            slot = int(pos[0])
            d = {"P": ch["P"][slot], "A": ch["A"][slot],
                 "start_iter": ch["start_iter"]}
            if "E" in ch:
                d["E"] = ch["E"][slot]
            chunks.append(d)
        if (not chunks or lo < chunks[0]["start_iter"]) and self._archive:
            chunks = self._archive
        Ps, Es, As = [], [], []
        for ch in chunks:
            n = ch["P"].shape[0]
            s, e = ch["start_iter"], ch["start_iter"] + n - 1
            if e < lo or s > end_iter:
                continue
            i0, i1 = max(lo - s, 0), min(end_iter - s, n - 1) + 1
            Ps.append(jnp.asarray(ch["P"][i0:i1]))
            As.append(np.asarray(ch["A"][i0:i1]))
            if "E" in ch:
                Es.append(jnp.asarray(ch["E"][i0:i1]))
        if not Ps:
            raise ValueError("no samples in requested window")
        E = jnp.concatenate(Es) if Es else None
        return jnp.concatenate(Ps), E, np.concatenate(As)


class ChainEnsemble:
    """Run ``n_chains`` independent Gibbs chains of the same model."""

    def __init__(
        self,
        data,
        rank,
        n_chains: int = 8,
        likelihood: str = "poisson",
        prior: str = "truncnormal",
        rank_method: str = "SBFI",
        MH: Optional[bool] = None,
        convergence_control: Optional[ConvergenceControl] = None,
        prop_temp: float = 0.2,
        post_warmup: Optional[int] = None,
        mesh=None,
        seed: int = 0,
        store_E: bool = True,
        output_dir: Optional[str] = None,
        overwrite: bool = False,
        hyperprior_params: Optional[dict] = None,
        init_prior_params: Optional[dict] = None,
        init_params: Optional[dict] = None,
        record_history: str = "basic",
        stream_sweeps: Optional[bool] = None,
        want_ci: bool = True,
        compact: bool = True,
        verbosity: int = 1,
        periodic_save: bool = True,
        save_all_samples: bool = False,
        A_masks=None,
    ):
        if record_history not in ("basic", "full"):
            raise ValueError("record_history must be 'basic' or 'full'")
        self.record = record_history
        self.row_names = None
        self.col_names = None
        if hasattr(data, "index") and hasattr(data, "columns"):
            self.row_names = [str(r) for r in data.index]
            self.col_names = [str(c) for c in data.columns]
            data = data.to_numpy()
        data = np.asarray(data, np.float32)
        if isinstance(rank, (int, np.integer)):
            ranks = [int(rank)]
        else:
            ranks = sorted(int(r) for r in rank)
        learning_rank = len(ranks) > 1
        if learning_rank and min(ranks) != 0:
            ranks = list(range(0, max(ranks) + 1))
        N = max(ranks)
        if MH is None:
            MH = default_MH(likelihood, prior)
        if stream_sweeps and mesh is not None:
            raise ValueError(
                "stream_sweeps kernels do not partition over a G-sharded "
                "mesh; use the XLA sweep path for mesh-sharded ensembles "
                "(chain-parallel scale-out needs no mesh: chains vmap on "
                "each chip and split across processes)")
        if stream_sweeps is None:
            stream_sweeps = _auto_stream_sweeps(
                likelihood, prior, MH, mesh, learning_rank, n_chains,
                data.shape[0], data.shape[1])
        self.spec = ModelSpec(
            K=data.shape[0], N=N, G=data.shape[1], likelihood=likelihood,
            prior=prior, MH=MH, learning_rank=learning_rank,
            rank_method=rank_method, stream_sweeps=stream_sweeps,
        )
        self.cc = convergence_control or ConvergenceControl()
        # Optional per-chain FIXED inclusion masks (n_chains, N): chain c
        # samples a rank-sum(A_masks[c]) model; excluded columns keep drawing
        # from the prior exactly like the reference's A_n = 0 dispatch
        # (sample_Pn.R:12-13), so each chain's included-column posterior is
        # identical in distribution to a dedicated rank-k fit. This is the
        # engine of the parallel min-BIC rank search (fit(rank_method='BIC')):
        # every candidate rank runs simultaneously in the ONE vmapped device
        # program instead of the reference's serial lapply (bayesNMF.R:67-105).
        self.A_masks = None
        if A_masks is not None:
            if learning_rank:
                raise ValueError(
                    "A_masks fixes per-chain ranks; incompatible with a "
                    "learned rank (pass a scalar rank = max candidate rank)")
            self.A_masks = np.asarray(A_masks, np.float32)
            if self.A_masks.shape != (n_chains, N):
                raise ValueError(
                    f"A_masks must have shape ({n_chains}, {N}), got "
                    f"{self.A_masks.shape}")
        self.n_chains = n_chains
        self.post_warmup = (post_warmup if post_warmup is not None
                            else 2 * self.cc.MAP_over) if MH else 0
        self.store_E = store_E
        self.seed = seed
        self.periodic_save = periodic_save
        self.want_ci = want_ci
        self.compact = compact

        from ..models.sampler import _resolve_output_dir

        self.output_dir = _resolve_output_dir(output_dir, overwrite)
        self.logger = RunLogger(self.output_dir, verbosity)
        self.logger.log(
            f"Initialized ensemble: {n_chains} chains, likelihood = "
            f"{likelihood}, prior = {prior}, MH = {MH}", 1)

        n_iters = self.cc.maxiters + self.post_warmup
        rng = np.random.default_rng(seed)
        if learning_rank:
            sched = gibbs.temp_schedule(
                n_iters, int(round(prop_temp * self.cc.maxiters)), rng)
        else:
            sched = np.ones(n_iters, np.float32)
        self.temp_sched = np.concatenate([[np.float32(0)], sched])

        # hyperprior defaults + user overrides (bayesNMF.R:35-37; setup.R:15-88
        # merges user values over defaults), same contract as GibbsSampler
        self.hp = dict(default_hyperprior_params(self.spec, float(data.mean())))
        if hyperprior_params:
            self.hp.update(hyperprior_params)
        if self.spec.likelihood == "normal":
            ipp = dict(init_prior_params or {})
            self.hp.setdefault("alpha", ipp.pop("alpha", 3.0))
            self.hp.setdefault("beta", ipp.pop("beta", 3.0))
            init_prior_params = ipp
        self._init_params = init_params
        self._init_prior_params = init_prior_params
        self.mesh = mesh
        self._data_np = data
        self._slots = np.arange(n_chains)
        self._attach_mesh(mesh)
        self.states = self._init_states(jax.random.PRNGKey(seed))

        # vectorized over chains: one (C,)-array tracker, not C objects —
        # O(1) numpy ops per chunk even at thousands of vmapped chains
        self.tracker = VectorConvergenceTracker(self.cc, n_chains)
        self.iter = 1
        # per-chain iteration at which the inference phase ends
        self._end_iter = np.full(n_chains, -1, np.int64)
        # _slots (set above): original chain ids of the device-resident slots
        # (compaction shrinks it; chunks/metrics are scattered back to
        # original positions so all per-chain bookkeeping is id-stable)
        self._window = []      # recent chunks (device) + chain_ids
        self._metric_rows = []  # list of (C_orig, chunk, n_metrics), NaN
        # rows for chains not resident when the chunk ran
        self._final_windows: dict = {}   # chain -> host sample window
        self._final_metrics: dict = {}   # chain -> (MAP_over, m) host rows
        # full sample archive (every chunk snapshotted to host): unlocks
        # label-switching diagnostics over the whole run and arbitrary
        # far-past get_MAP(end_iter=) windows per chain — the ensemble analog
        # of GibbsSampler's save_all_samples (bayesNMF_sampler.R:651-672 /
        # postprocessing_visualizations.R:598-787 requires it). Off by
        # default: at ensemble scale the archive is C x iters x (K+N) x G.
        self._archive: Optional[list] = [] if save_all_samples else None
        self.MAP_per_chain: list = [None] * n_chains
        # per-chain MAP-metric rows, one per convergence check (the serial
        # driver's MAP_metrics contract, update_MAP_metrics_ utils.R:356-397)
        self._MAP_metrics_per_chain: list = [[] for _ in range(n_chains)]
        self._reference_comparisons: dict = {}
        self.time = {}

    # ------------------------------------------------------------------
    # device plumbing (mesh-aware; re-entrant for checkpoint resume)
    # ------------------------------------------------------------------

    def _attach_mesh(self, mesh):
        self.mesh = mesh
        if mesh is not None:
            from . import mesh as M

            self._make_sharded_runner(self._slots.size)
            self.data = jax.device_put(
                jnp.asarray(self._data_np), M.data_sharding(mesh))
        else:
            self._init_fn = None
            self._run_fn = None
            self.data = jnp.asarray(self._data_np)

    def _make_sharded_runner(self, n_resident: int):
        self._init_fn, self._run_fn = chains_mod.make_sharded_chain_runner(
            self.spec, self.mesh, n_resident, record=self.record,
            store_E=self.store_E)

    def _init_states(self, key):
        if self._init_fn is not None:
            states = self._init_fn(self.hp, self.data, key)
        else:
            states = chains_mod.init_chain_states(
                self.spec, self.hp, self.data, key, self.n_chains,
                self._init_params, self._init_prior_params)
        if self.A_masks is not None:
            # fixed per-chain inclusion: A never updates (learning_rank is
            # False), so setting it once pins each chain's rank for the run
            states["params"]["A"] = jax.device_put(
                jnp.asarray(self.A_masks),
                states["params"]["A"].sharding)
            states["params"]["R"] = jax.device_put(
                jnp.asarray(self.A_masks.sum(axis=1), jnp.int32),
                states["params"]["R"].sharding)
        return states

    # ------------------------------------------------------------------

    def _accept_all_vec(self):
        return jnp.asarray(
            (self.spec.MH & ~self.tracker.converged)[self._slots])

    def _run_chunk(self, steps: int):
        temps = jnp.asarray(
            self.temp_sched[self.iter + 1: self.iter + steps + 1])
        acc = self._accept_all_vec()
        if self._run_fn is not None:
            self.states, samples = self._run_fn(
                self.data, self.hp, self.states, temps, acc)
        else:
            self.states, samples = chains_mod.run_chunk_chains(
                self.spec, self.data, self.hp, self.states, temps, acc,
                record=self.record, store_E=self.store_E)
        chunk = {k: v for k, v in samples.items() if k != "metrics"}
        chunk["start_iter"] = self.iter + 1
        chunk["chain_ids"] = self._slots.copy()
        self._window.append(chunk)
        if self._archive is not None:
            self._archive.append({
                k: (v if k == "start_iter" else jax.tree.map(np.asarray, v))
                for k, v in chunk.items()})
        max_chunks = -(-self.cc.MAP_over // self.cc.MAP_every) + 1
        if len(self._window) > max_chunks:
            self._window.pop(0)
        rows = np.full((self.n_chains, steps, gibbs.N_METRICS), np.nan,
                       np.float32)
        rows[self._slots] = np.asarray(samples["metrics"])
        self._metric_rows.append(rows)
        self.iter += steps

    def _metrics_all(self):
        return np.concatenate(self._metric_rows, axis=1)  # (C, iters, m)

    def _metrics_tail(self, n: int):
        return self._metrics_all()[:, -n:, :]

    def _check_convergence(self):
        win = self._metrics_tail(self.cc.MAP_over)
        # per-chain MAP metric: mean of loglik/logpost over window, as the
        # reference does (update_MAP_metrics_, utils.R:369-379)
        col = {"loglikelihood": 3, "logposterior": 4, "RMSE": 1, "KL": 2}[
            self.cc.metric]
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN rows
            vals = np.nanmean(win[:, :, col], axis=1)
        if self.cc.metric in ("loglikelihood", "logposterior"):
            vals = -vals
        self._append_map_metric_rows(win)
        temps_all_one = bool(np.all(
            self.temp_sched[max(self.iter - self.cc.MAP_over, 1):
                            self.iter + 1] == 1.0))
        newly = self.tracker.update(vals, self.iter, temps_all_one)
        self._end_iter[newly] = self.iter + self.post_warmup
        for c in np.nonzero(newly)[0]:
            self.logger.log(
                f"chain {c} converged at {self.iter} due to "
                f"{self.tracker.why(c)}", 1)
        n_conv = int(self.tracker.converged.sum())
        self.logger.log(
            f"iter = {self.iter}: {n_conv}/{self.n_chains} chains "
            "converged", 1)
        if self.periodic_save and self.output_dir:
            self.save_object()

    def _append_map_metric_rows(self, win):
        """Per-chain MAP-metric rows at this convergence check, built from
        the vectorized window metrics (update_MAP_metrics_, utils.R:356-397;
        the serial driver's contract at sampler.py::_map_check).

        loglik/logpost/BIC are window means exactly like the serial row;
        RMSE/KL are window means of the per-SAMPLE metrics rather than of a
        freshly computed MAP estimate (computing C MAPs per check would cost
        a window gather per chain — the sample means track the same signal).
        Rows stop once a chain's run has ended (its ``_end_iter`` passed),
        like the serial sampler stops at its own run end."""
        G, K = self.spec.G, self.spec.K
        mean_temp = float(np.mean(
            self.temp_sched[max(self.iter - self.cc.MAP_over + 1, 1):
                            self.iter + 1]))
        for c in range(self.n_chains):
            if 0 < self._end_iter[c] < self.iter:
                continue  # chain's run ended at an earlier check
            w = win[c]
            w = w[~np.isnan(w[:, 0])]
            if w.shape[0] == 0:
                continue  # compacted away before this check
            mean_ll = float(w[:, 3].mean())
            rank = float(w[-1, 7])
            n_par = rank * (G + K)
            row = {
                "iter": self.iter,
                "RMSE": float(w[:, 1].mean()),
                "KL": float(w[:, 2].mean()),
                "loglikelihood": mean_ll,
                "logposterior": float(w[:, 4].mean()),
                "n_params": n_par,
                "BIC": -2.0 * mean_ll + n_par * np.log(G),
                "rank": rank,
                "mean_temp": mean_temp,
            }
            if self.spec.MH:
                row["P_mean_acceptance_rate"] = float(w[-1, 9])
                row["E_mean_acceptance_rate"] = float(w[-1, 10])
            self._MAP_metrics_per_chain[c].append(row)

    # ------------------------------------------------------------------
    # finalization + compaction
    # ------------------------------------------------------------------

    def _finished_mask(self):
        return self.tracker.converged & (self._end_iter > 0) & (
            self._end_iter <= self.iter)

    def _finalize_chain(self, c: int):
        """Snapshot chain ``c``'s inference window (ending at its own
        ``_end_iter``, the reference's final-MAP window — bayesNMF.R:95-97)
        to host memory and compute its MAP + credible intervals."""
        end = int(self._end_iter[c])
        end = end if 0 < end <= self.iter else self.iter
        view = _ChainView(self, c)
        lo = max(end - self.cc.MAP_over + 1, 2)
        fin: dict = {"end_iter": end}
        # gather every recorded tensor for this chain over [lo, end]
        got = 0
        for ch in self._window:
            pos = np.nonzero(ch["chain_ids"] == c)[0]
            if pos.size == 0:
                continue
            slot = int(pos[0])
            n = ch["P"].shape[1]
            s, e = ch["start_iter"], ch["start_iter"] + n - 1
            if e < lo or s > end:
                continue
            i0, i1 = max(lo - s, 0), min(end - s, n - 1) + 1
            got += i1 - i0
            for k, v in ch.items():
                if k in ("start_iter", "chain_ids"):
                    continue
                if isinstance(v, dict):
                    for pk, pv in v.items():
                        fin.setdefault(pk, []).append(
                            np.asarray(pv[slot, i0:i1]))
                else:
                    fin.setdefault(k, []).append(np.asarray(v[slot, i0:i1]))
        if got:
            fin = {k: (np.concatenate(v) if isinstance(v, list) else v)
                   for k, v in fin.items()}
            self._final_windows[c] = fin
        # metrics over the same window (for bic_table / diagnostics)
        rows = self._metrics_all()[c]
        j1 = rows.shape[0] - (self.iter - end)
        j0 = max(j1 - self.cc.MAP_over, 0)
        self._final_metrics[c] = rows[j0:j1]
        try:
            P_h = jnp.asarray(self._final_windows[c]["P"])
            E_h = (jnp.asarray(self._final_windows[c]["E"])
                   if "E" in self._final_windows[c] else None)
            A_h = self._final_windows[c]["A"]
            res = compute_map(P_h, E_h, A_h, final=True,
                              want_ci=self.want_ci)
            res["idx"] = np.arange(end - A_h.shape[0] + 1, end + 1)[
                res["idx_mask"]]
            res["sig_idx"] = np.arange(len(res["keep_sigs"]))
            self.MAP_per_chain[c] = res
        except (KeyError, ValueError):
            # window not retrievable (resumed from a stripped checkpoint):
            # fall back to whatever live window exists
            try:
                view.get_MAP()
            except ValueError:
                pass

    def _maybe_compact(self):
        """Shrink the resident ensemble to the still-running chains.

        Converged-and-finished chains otherwise execute full Gibbs sweeps
        until the slowest chain finishes (pure waste — with tempered SBFI
        chains heterogeneous convergence is the normal case). Buckets are
        powers of two so at most log2(C) distinct program shapes compile.
        """
        finished = self._finished_mask()
        live = np.nonzero(~finished)[0]
        resident = self._slots.size
        if live.size == 0 or live.size > resident // 2:
            return
        bucket = 1 << int(np.ceil(np.log2(live.size)))
        if self.mesh is not None:
            # the chain axis stays sharded: only shrink to multiples of it
            n_chain_dev = dict(
                zip(self.mesh.axis_names, self.mesh.devices.shape)).get(
                    "chain", 1)
            if bucket % n_chain_dev:
                bucket = n_chain_dev * (-(-bucket // n_chain_dev))
            if bucket >= resident:
                return
        # pad with finished chains (their extra draws are valid posterior
        # samples and simply ignored) to fill the power-of-two bucket
        live_set = set(int(c) for c in live)
        pad = [int(c) for c in self._slots if int(c) not in live_set]
        keep_ids = np.concatenate(
            [live, np.asarray(pad[: bucket - live.size], np.int64)])
        pos_of = {int(c): i for i, c in enumerate(self._slots)}
        take = np.asarray([pos_of[int(c)] for c in keep_ids], np.int32)
        self.states = jax.tree.map(lambda x: x[np.asarray(take)], self.states)
        self._slots = keep_ids.astype(np.int64)
        if self._run_fn is not None:
            from . import mesh as M

            self._make_sharded_runner(self._slots.size)
            self.states = jax.device_put(
                self.states,
                M.state_shardings(self.spec, self.mesh, chains=True))
        self.logger.log(
            f"compacted ensemble to {self._slots.size} resident chains "
            f"({live.size} live)", 1)

    def run(self):
        """Run all chains to completion (resumable: continues from the
        current iteration after ``ChainEnsemble.load``); returns self."""
        t0 = time.time()
        cc = self.cc
        self.logger.log("Starting ensemble Gibbs sampler", 1)
        hard_stop = cc.maxiters + self.post_warmup

        def all_done():
            return bool(np.all(self._finished_mask()))

        while self.iter < hard_stop and not all_done():
            boundary = ((self.iter // cc.MAP_every) + 1) * cc.MAP_every
            boundary = min(boundary, hard_stop)
            self._run_chunk(boundary - self.iter)
            if self.iter % cc.MAP_every == 0 or self.iter >= hard_stop:
                self._check_convergence()
                finished = self._finished_mask()
                for c in np.nonzero(finished)[0]:
                    if c not in self._final_windows and (
                            self.MAP_per_chain[c] is None):
                        self._finalize_chain(c)
                if self.compact:
                    self._maybe_compact()
        self.time["total"] = self.time.get("total", 0.0) + (
            time.time() - t0) / 60.0
        self.time["iters"] = self.iter
        self._compute_maps()
        self.logger.log(
            f"Ensemble done: {self.iter} iterations, "
            f"{self.throughput():.1f} chain-it/s", 1)
        if self.output_dir:
            self.save_object()
        return self

    def _compute_maps(self):
        """Finalize every chain that still lacks a MAP (end of run: chains
        that never converged get the global tail window)."""
        for c in range(self.n_chains):
            if self.MAP_per_chain[c] is None:
                if self._end_iter[c] <= 0:
                    self._end_iter[c] = self.iter
                self._finalize_chain(c)

    # ------------------------------------------------------------------
    # persistence (checkpoint + bit-exact resume)
    # ------------------------------------------------------------------

    def save_object(self, path: Optional[str] = None):
        from ..utils.checkpoint import save_ensemble

        path = path or (os.path.join(self.output_dir, "ensemble.ckpt")
                        if self.output_dir else "ensemble.ckpt")
        save_ensemble(self, path)
        return path

    @classmethod
    def load(cls, path: str, mesh=None):
        from ..utils.checkpoint import load_ensemble

        return load_ensemble(cls, path, mesh=mesh)

    # ------------------------------------------------------------------
    # postprocessing entry points
    # ------------------------------------------------------------------

    def chain(self, c: int) -> _ChainView:
        """Single-chain view for the shared postprocessing machinery."""
        if self.MAP_per_chain[c] is None:
            self._compute_maps()
        return _ChainView(self, c)

    def assign_signatures(self, reference_P="cosmic", credible_interval=0.95):
        """Per-chain posterior-ensemble reference assignment
        (assign_signatures_ensemble_, postprocessing.R:175-341, run per
        chain). Returns {chain: {'assignments', 'votes'}}."""
        from ..utils.postprocessing import assign_signatures_ensemble

        return {
            c: assign_signatures_ensemble(
                self.chain(c), reference_P=reference_P,
                credible_interval=credible_interval)
            for c in range(self.n_chains)
        }

    def summary(self, reference_P="cosmic"):
        """Pooled cross-chain summary: one row per (chain, signature) with
        the per-chain reference assignment and cosine (summarize_samplers,
        postprocessing.R:114-152, over chains instead of samplers)."""
        import pandas as pd

        from ..utils.postprocessing import sampler_summary

        if not self.store_E:
            raise ValueError(
                "summary() needs exposure medians; rerun with store_E=True "
                "(assign_signatures() works without E)")
        frames = []
        for c in range(self.n_chains):
            df = sampler_summary(self.chain(c), reference_P).copy()
            df.insert(0, "Chain", c)
            frames.append(df)
        return pd.concat(frames, ignore_index=True)

    def pooled_assignment(self, reference_P="cosmic"):
        """Majority assignment across chains: for each reference signature,
        the fraction of chains whose MAP includes a signature assigned to it.
        The cross-chain analog of the reference's within-chain vote pooling."""
        import pandas as pd

        per_chain = self.assign_signatures(reference_P)
        rows = []
        for c, res in per_chain.items():
            a = res["assignments"]
            for _, r in a.iterrows():
                rows.append({"Chain": c, "sig_ref": r.sig_ref,
                             "MAP_cosine": r.MAP_cosine})
        df = pd.DataFrame(rows)
        agg = df.groupby("sig_ref").agg(
            n_chains=("Chain", "nunique"),
            mean_cosine=("MAP_cosine", "mean"),
        ).reset_index()
        agg["prop_chains"] = agg["n_chains"] / self.n_chains
        return agg.sort_values("prop_chains", ascending=False).reset_index(
            drop=True)

    # ------------------------------------------------------------------

    def _chain_metrics_window(self, c: int):
        """Chain ``c``'s final MAP_over-iteration metric window (its OWN
        post-convergence window when finalized, else the global tail)."""
        fin = self._final_metrics.get(c)
        if fin is not None:
            return fin
        return self._metrics_tail(self.cc.MAP_over)[c]

    def bic_table(self):
        """Per-chain BIC over each chain's own final MAP_over-iteration
        window (ending at its ``_end_iter``, matching MAP_per_chain and the
        reference's final-BIC extraction, bayesNMF.R:95-97):
        BIC = -2*mean(loglik) + n_params*log(G). Returns a DataFrame sorted
        by BIC with one row per chain (columns: chain, rank, BIC, loglik)."""
        import pandas as pd
        import warnings

        rows = []
        for c in range(self.n_chains):
            win = self._chain_metrics_window(c)  # (S, m)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                mean_ll = float(np.nanmean(win[:, 3]))
            ok = ~np.isnan(win[:, 0])
            last = np.nonzero(ok)[0][-1] if ok.any() else -1
            n_params = float(win[last, 5])
            rank = float(win[last, 7])
            rows.append({
                "chain": c, "rank": int(rank),
                "BIC": -2.0 * mean_ll + n_params * np.log(self.spec.G),
                "loglik": mean_ll,
            })
        return pd.DataFrame(rows).sort_values("BIC").reset_index(drop=True)

    @property
    def learned_ranks(self):
        return np.array([
            int(np.asarray(m_["A_full"]).sum()) if m_ is not None else -1
            for m_ in self.MAP_per_chain])

    def throughput(self):
        """Chain-iterations per second over the whole run."""
        secs = self.time["total"] * 60.0
        return self.n_chains * self.iter / max(secs, 1e-9)

    def diagnostics(self, metrics=("logposterior", "loglikelihood",
                                   "RMSE", "rank"),
                    n_draws: Optional[int] = None):
        """Cross-chain convergence report: rank-normalized split-R̂ and
        bulk/tail ESS per metric (see parallel/diagnostics.py). Defaults to
        each chain's own retained inference window (``n_draws=MAP_over``)."""
        from .diagnostics import ensemble_diagnostics

        if n_draws is None:
            n_draws = self.cc.MAP_over
        return ensemble_diagnostics(self, metrics=metrics, n_draws=n_draws)

    def metrics_stack(self, n_draws: int):
        """(C, n_draws, m) stack of per-chain metric windows, each chain's
        own inference window when finalized (NaN-padded if shorter)."""
        out = np.full((self.n_chains, n_draws, gibbs.N_METRICS), np.nan,
                      np.float32)
        for c in range(self.n_chains):
            win = self._chain_metrics_window(c)
            w = win[-n_draws:]
            out[c, -w.shape[0]:] = w
        return out
