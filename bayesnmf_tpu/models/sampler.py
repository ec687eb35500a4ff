"""Host-side sampler driver: phases, convergence checks, MAP windows, I/O.

Equivalent of the bayesNMF_sampler R6 class + bayesNMF() driver
(/root/reference/R/bayesNMF_sampler.R, bayesNMF.R). The hot loop runs on
device in jitted chunks of MAP_every iterations (models/gibbs.py); this class
owns everything at chunk granularity: sample windows, metrics history,
convergence, logging, checkpointing, and postprocessing entry points.
"""

from __future__ import annotations

import collections
import os
import shutil
import time
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (
    ConvergenceControl,
    ModelSpec,
    RunConfig,
    default_MH,
    default_hyperprior_params,
)
from ..utils.logging import RunLogger, format_counts_table
from . import gibbs
from .convergence import ConvergenceTracker
from .map_estimate import compute_map, map_quality_metrics


def _resolve_output_dir(output_dir: Optional[str], overwrite: bool) -> Optional[str]:
    """Collision-suffixing `_1,_2,...` or wipe-on-overwrite
    (bayesNMF_sampler.R:111-121)."""
    if output_dir is None:
        return None
    final = output_dir
    tail = 0
    while not overwrite and os.path.isdir(final):
        tail += 1
        final = f"{output_dir}_{tail}"
    if overwrite and os.path.isdir(final):
        shutil.rmtree(final)
    os.makedirs(final, exist_ok=True)
    return final


class GibbsSampler:
    """Single-chain Bayesian NMF Gibbs sampler (device-resident hot loop)."""

    def __init__(
        self,
        data,
        rank,
        likelihood: str = "poisson",
        prior: str = "truncnormal",
        rank_method: str = "SBFI",
        MH: Optional[bool] = None,
        convergence_control: Optional[ConvergenceControl] = None,
        prop_temp: float = 0.2,
        post_warmup: Optional[int] = None,
        output_dir: Optional[str] = None,
        overwrite: bool = False,
        hyperprior_params: Optional[dict] = None,
        init_prior_params: Optional[dict] = None,
        init_params: Optional[dict] = None,
        verbosity: int = 1,
        periodic_save: bool = True,
        save_all_samples: bool = True,
        record_history: str = "basic",
        mesh=None,
        seed: int = 0,
    ):
        if record_history not in ("basic", "full"):
            raise ValueError("record_history must be 'basic' or 'full'")
        # "full" records prior params, sigmasq, and MH acceptance matrices
        # every iteration, like the reference's record_sample
        # (bayesNMF_sampler.R:651-672); "basic" records P/E/A + metrics only.
        self.record_full = record_history == "full"
        # DataFrame input keeps its dimnames (like an R matrix): row names
        # drive signature plots and reference row-reordering, column names
        # label exposures.
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
            ranks = list(range(0, max(ranks) + 1))  # bayesNMF_sampler.R:125
        N = max(ranks)
        if MH is None:
            MH = default_MH(likelihood, prior)

        self.spec = ModelSpec(
            K=data.shape[0], N=N, G=data.shape[1],
            likelihood=likelihood, prior=prior, MH=MH,
            learning_rank=learning_rank, rank_method=rank_method,
        )
        self.cc = convergence_control or ConvergenceControl()
        self.run_cfg = RunConfig(
            prop_temp=prop_temp, post_warmup=post_warmup,
            output_dir=output_dir, overwrite=overwrite, verbosity=verbosity,
            periodic_save=periodic_save, save_all_samples=save_all_samples,
            seed=seed,
        )
        self.rank = ranks if learning_rank else ranks[0]
        self.post_warmup = self.run_cfg.resolved_post_warmup(self.cc)
        self.output_dir = _resolve_output_dir(output_dir, overwrite)
        self.logger = RunLogger(self.output_dir, verbosity)

        # tempering schedule, 1-indexed by iteration (utils.R:307-332;
        # bayesNMF_sampler.R:128-137)
        n_iters = self.cc.maxiters + (self.post_warmup if MH else 0)
        rng = np.random.default_rng(seed)
        if learning_rank:
            sched = gibbs.temp_schedule(
                n_iters, int(round(prop_temp * self.cc.maxiters)), rng)
        else:
            sched = np.ones(n_iters, np.float32)
        self.temp_sched = np.concatenate([[np.float32(0)], sched])  # [iter]

        # Optional G-sharding of a single large fit over a device mesh: data
        # M (K,G), exposures E (N,G), Zsum_k and sigmasq live distributed over
        # the mesh's 'g' axis (parallel/mesh.py layout); GSPMD turns the
        # sweeps' G-contractions into psums between devices. This answers
        # the reference's full-matrix residency (get_Mhat/sample_Zkg,
        # utils.R:29-49, sample_params.R:253-265) at PCAWG/100k-genome scale.
        self.mesh = mesh
        if mesh is not None:
            from ..parallel import mesh as Mm

            self._state_sharding = Mm.state_shardings(
                self.spec, mesh, chains=False)
            self.data = jax.device_put(
                jnp.asarray(data), Mm.data_sharding(mesh))
        else:
            self._state_sharding = None
            self.data = jnp.asarray(data)
        self.dims = {"K": self.spec.K, "N": N, "G": self.spec.G}
        self.hyperprior_params = dict(
            default_hyperprior_params(self.spec, float(data.mean()))
        )
        if hyperprior_params:
            self.hyperprior_params.update(hyperprior_params)
        if self.spec.likelihood == "normal":
            # default InvGamma(3,3) prior for sigmasq (bayesNMF_sampler.R:222-230)
            ipp = dict(init_prior_params or {})
            self.hyperprior_params.setdefault("alpha", ipp.pop("alpha", 3.0))
            self.hyperprior_params.setdefault("beta", ipp.pop("beta", 3.0))
            init_prior_params = ipp

        self.logger.log("Initialized sampler", 1)
        self.logger.indent = 1
        self.logger.log(
            f"likelihood = {likelihood}, prior = {prior}, MH = {MH}", 1)
        disp = f"{min(ranks)}:{max(ranks)}" if learning_rank else str(self.rank)
        self.logger.log(f"learning_rank = {learning_rank}, rank = {disp}", 1)
        self.logger.log(f"maxiters = {self.cc.maxiters}", 1)
        self.logger.log(f"MAP_over = {self.cc.MAP_over}", 1)
        self.logger.log(f"MAP_every = {self.cc.MAP_every}", 1)
        self.logger.indent = 0

        key = jax.random.PRNGKey(seed)
        self.state = gibbs.init_state(
            self.spec, self.hyperprior_params, self.data, key,
            init_params=init_params, init_prior_params=init_prior_params,
        )
        if self._state_sharding is not None:
            self.state = jax.device_put(self.state, self._state_sharding)
        self.tracker = ConvergenceTracker(self.cc)
        self.iter = 1
        self.time = {}
        self.MAP: Optional[dict] = None
        self.credible_intervals: Optional[dict] = None
        self.MAP_metrics: list[dict] = []
        self.reference_comparison: dict = {}

        # sample storage: chunks of (C, ...) arrays with their start iteration
        window_chunks = -(-self.cc.MAP_over // self.cc.MAP_every) + 1
        self._window = collections.deque(maxlen=window_chunks)
        self._archive = [] if save_all_samples else None
        self._metric_rows: list[np.ndarray] = []

        # record the initial sample (iteration 1), bayesNMF_sampler.R:240-257
        snap = gibbs.snapshot_sample(
            self.spec, self.data, self.state, jnp.float32(self.temp_sched[1]),
            record_full=self.record_full)
        self._append_chunk(jax.tree.map(lambda x: x[None], snap), start_iter=1)

    # ------------------------------------------------------------------
    # sample storage
    # ------------------------------------------------------------------

    def _append_chunk(self, samples: dict, start_iter: int):
        chunk = {
            "P": samples["P"], "E": samples["E"], "A": samples["A"],
            "start_iter": start_iter,
        }
        self._window.append(chunk)
        self._metric_rows.append(np.asarray(samples["metrics"]))
        if self._archive is not None:
            # issue ASYNC device->host copies now and materialize this chunk
            # at the NEXT boundary: the transfer overlaps the following
            # chunk's device compute instead of stalling the driver. At most
            # one chunk of history occupies device memory beyond the
            # retained window.
            extra = {k: v for k, v in samples.items() if k != "metrics"}
            jax.tree.map(
                lambda x: x.copy_to_host_async()
                if hasattr(x, "copy_to_host_async") else None, extra)
            if self._archive:
                self._archive[-1] = {
                    k: (v if k == "start_iter" else jax.tree.map(np.asarray,
                                                                 v))
                    for k, v in self._archive[-1].items()}
            self._archive.append(extra | {"start_iter": start_iter})

    def _gather_window(self, end_iter: int, n_samples: int):
        """Stack the last ``n_samples`` recorded samples ending at end_iter."""
        lo = end_iter - n_samples + 1
        sources = list(self._window)
        if not sources or lo < sources[0]["start_iter"]:
            if self._archive is None:
                raise ValueError(
                    "requested window precedes the retained sample window; "
                    "rerun with save_all_samples=True"
                )
            sources = self._archive
        Ps, Es, As = [], [], []
        for ch in sources:
            c = ch["P"].shape[0]
            s, e = ch["start_iter"], ch["start_iter"] + c - 1
            if e < lo or s > end_iter:
                continue
            i0, i1 = max(lo - s, 0), min(end_iter - s, c - 1) + 1
            Ps.append(jnp.asarray(ch["P"][i0:i1]))
            Es.append(jnp.asarray(ch["E"][i0:i1]))
            As.append(np.asarray(ch["A"][i0:i1]))
        if not Ps:
            raise ValueError("no samples in requested window")
        return (jnp.concatenate(Ps), jnp.concatenate(Es), np.concatenate(As))

    @property
    def sample_metrics(self):
        """Per-iteration metrics as a pandas DataFrame (sample_metrics,
        bayesNMF_sampler.R:190-207)."""
        import pandas as pd

        rows = np.concatenate(self._metric_rows, axis=0)
        return pd.DataFrame(rows, columns=list(gibbs.METRIC_NAMES))

    @property
    def samples(self):
        """Dict of stacked sample histories (save_all_samples=True) or the
        retained window.

        With ``record_history='full'`` this additionally exposes the prior
        parameter histories under their reference names (e.g.
        ``samples['Lambda_p']``, ``samples['Mu_e']``), ``samples['sigmasq']``
        and the per-entry MH acceptance histories ``samples['acc_P']`` /
        ``samples['acc_E']`` — parity with the reference's
        ``sampler$samples`` (bayesNMF_sampler.R:651-672).
        """
        src = self._archive if self._archive is not None else list(self._window)
        out = {
            "P": np.concatenate([np.asarray(c["P"]) for c in src]),
            "E": np.concatenate([np.asarray(c["E"]) for c in src]),
            "A": np.concatenate([np.asarray(c["A"]) for c in src]),
            "start_iter": src[0]["start_iter"],
        }
        for key in ("sigmasq", "acc_P", "acc_E"):
            if key in src[0]:
                out[key] = np.concatenate([np.asarray(c[key]) for c in src])
        if "prior" in src[0]:
            for pk in src[0]["prior"]:
                out[pk] = np.concatenate(
                    [np.asarray(c["prior"][pk]) for c in src])
        return out

    def posterior_summary(self, name: str, q=(0.025, 0.5, 0.975)):
        """Posterior mean + quantiles of a recorded scalar-per-entry history
        (e.g. 'sigmasq', 'Lambda_p', 'acc_P') over the retained samples —
        the diagnostic use the reference enables by keeping samples$sigmasq,
        samples$Lambda_p, etc. Requires record_history='full' for
        prior-param/acceptance names."""
        hist = self.samples
        if name not in hist:
            raise KeyError(
                f"{name!r} not recorded; run with record_history='full' "
                f"(available: {sorted(k for k in hist if k != 'start_iter')})")
        x = np.asarray(hist[name])
        return {
            "mean": x.mean(axis=0),
            "quantiles": {qi: np.quantile(x, qi, axis=0) for qi in q},
            "n_samples": x.shape[0],
        }

    # ------------------------------------------------------------------
    # model math conveniences (parity with the R6 public methods)
    # ------------------------------------------------------------------

    def get_Mhat(self, P=None, A=None, E=None):
        from ..ops import math as m

        p = self.state["params"]
        return m.mhat(
            jnp.asarray(P if P is not None else p["P"]),
            jnp.asarray(A if A is not None else p["A"]),
            jnp.asarray(E if E is not None else p["E"]),
        )

    def get_loglik(self, P=None, A=None, E=None, sigmasq=None,
                   likelihood=None, return_matrix=False):
        from ..ops import math as m

        p = self.state["params"]
        Mh = self.get_Mhat(P, A, E)
        lik = likelihood or self.spec.likelihood
        sq = sigmasq if sigmasq is not None else p.get("sigmasq")
        mat = m.loglik_mat(self.data, Mh, lik, jnp.asarray(sq) if sq is not None else None)
        return mat if return_matrix else jnp.sum(mat)

    def get_logpost(self, P=None, A=None, E=None, sigmasq=None):
        from ..ops import math as m

        p = self.state["params"]
        ll = self.get_loglik(P, A, E, sigmasq)
        return ll + m.logprior_PE(
            jnp.asarray(P if P is not None else p["P"]),
            jnp.asarray(E if E is not None else p["E"]),
            self.spec.prior, self.state["prior"],
        )

    # ------------------------------------------------------------------
    # MAP
    # ------------------------------------------------------------------

    def get_MAP(self, end_iter=None, n_samples=None, final=False,
                credible_interval=0.95):
        """Compute the MAP estimate over a sample window (get_MAP_,
        utils.R:194-288); updates self.MAP / self.credible_intervals."""
        end_iter = self.iter if end_iter is None else end_iter
        # over however many samples exist, up to MAP_over (utils.R:207:
        # MAP_idx = max(1, iter-MAP_over+1):iter)
        n_samples = min(n_samples or self.cc.MAP_over, end_iter)
        if end_iter != self.iter and self._archive is None:
            raise ValueError(
                "end_iter requires save_all_samples=True (utils.R:210-212)")
        P_h, E_h, A_h = self._gather_window(end_iter, n_samples)
        res = compute_map(P_h, E_h, A_h, final=final,
                          credible_interval=credible_interval)
        res["idx"] = np.arange(end_iter - A_h.shape[0] + 1, end_iter + 1)[
            res["idx_mask"]]
        res["sig_idx"] = np.arange(len(res["keep_sigs"]))
        self.MAP = res
        self.credible_intervals = res.get("credible_intervals")
        return res

    # ------------------------------------------------------------------
    # the run loop
    # ------------------------------------------------------------------

    def _run_chunk(self, steps: int, accept_all: bool):
        temps = jnp.asarray(
            self.temp_sched[self.iter + 1: self.iter + steps + 1])
        self.state, samples = gibbs.run_chunk(
            self.spec, self.data, self.hyperprior_params, self.state, temps,
            accept_all, record_full=self.record_full)
        self._append_chunk(samples, start_iter=self.iter + 1)
        self.iter += steps

    def _map_check(self, final: bool = False):
        """MAP + convergence bookkeeping at a chunk boundary
        (bayesNMF_sampler.R:288-329 / update_MAP_metrics_, utils.R:356-397)."""
        self.logger.log(f"iter = {self.iter}", 1)
        self.logger.indent = 2
        self.logger.log("Computing MAP", 1)
        self.get_MAP(final=final)
        if self.spec.learning_rank:
            self.logger.log(format_counts_table(self.MAP["A_counts"]), 1)

        # MAP metrics: loglik/logpost averaged over the window's sample
        # metrics (renormalized P/E invalidate the prior), BIC recomputed
        rows = np.concatenate(self._metric_rows, axis=0)
        win = rows[-self.cc.MAP_over:]
        mean_ll = float(np.nanmean(win[:, 3]))
        mean_lp = float(np.nanmean(win[:, 4]))
        q = map_quality_metrics(self.data, self.MAP, self.spec.G, self.spec.K)
        row = {
            "iter": self.iter,
            "RMSE": q["RMSE"], "KL": q["KL"],
            "loglikelihood": mean_ll, "logposterior": mean_lp,
            "n_params": q["n_params"],
            "BIC": -2.0 * mean_ll + q["n_params"] * np.log(self.spec.G),
            "rank": q["rank"],
            "MAP_A_counts": self.MAP["A_counts"][0][1],
            "mean_temp": float(
                np.mean(self.temp_sched[
                    max(self.iter - self.cc.MAP_over + 1, 1): self.iter + 1])),
        }
        if self.spec.MH:
            row["P_mean_acceptance_rate"] = float(win[-1, 9])
            row["E_mean_acceptance_rate"] = float(win[-1, 10])
        self.MAP_metrics.append(row)

        # surface numeric-overflow fallbacks (the reference logs its
        # NA-overflow ladder state, sample_params.R:136-162)
        na_col = gibbs.METRIC_NAMES.index("NA_events")
        na_events = float(np.nansum(self._metric_rows[-1][:, na_col]))
        if na_events > 0:
            self.logger.log(
                f"{int(na_events)} numeric-overflow fallbacks in the last "
                "chunk (MH ratios clamped NaN→0 / inclusion odds NaN→1/2)", 1)

        metric = row[self.cc.metric]
        if self.cc.metric in ("loglikelihood", "logposterior"):
            metric = -metric
        temps_all_one = bool(
            np.all(self.temp_sched[
                max(self.iter - self.cc.MAP_over, 1): self.iter + 1] == 1.0))
        msg = self.tracker.update(metric, self.iter, temps_all_one)
        self.logger.log("Checking convergence", 1)
        self.logger.log(msg, 1)
        self.logger.indent = 1
        if self.tracker.converged and self.tracker.converged_iter == self.iter:
            self.logger.log(
                f"Converged at {self.iter} due to {self.tracker.why}", 1)
        if self.run_cfg.periodic_save and self.output_dir:
            self.logger.log("Saving object", 1)
            self.save_object()
            # live-updating trace plots at every check, as the reference does
            # (utils.R:344-347, 394-396)
            try:
                from ..utils import plotting

                plotting.trace_plot(self, save=True)
                plotting.trace_plot(self, MAP_means=True, save=True)
                import matplotlib.pyplot as plt

                plt.close("all")
            except Exception as e:  # plotting must never kill a run
                self.logger.log(f"trace plot failed: {e}", 1)

    def run_gibbs_sampler(self, profile_dir: Optional[str] = None):
        """Warmup until convergence/maxiters, then post_warmup MH inference
        samples (run_gibbs_sampler, bayesNMF_sampler.R:265-408).

        ``profile_dir`` wraps the run in a jax.profiler trace (SURVEY §5: the
        reference only has Sys.time() wall-clock diffs)."""
        if profile_dir:
            import jax.profiler

            with jax.profiler.trace(profile_dir):
                return self._run_gibbs_sampler_impl()
        return self._run_gibbs_sampler_impl()

    def _run_gibbs_sampler_impl(self):
        self.logger.log("Starting Gibbs sampler", 1)
        self.logger.indent = 1
        t0 = time.time()
        cc = self.cc

        # ---- warmup phase -------------------------------------------------
        # convergence is checked every MAP_every iterations from the start,
        # over however many samples exist — matching the reference
        # (bayesNMF_sampler.R:288-296, utils.R:207), not only once MAP_over
        # samples have accumulated.
        while not self.tracker.converged and self.iter < cc.maxiters:
            boundary = min(
                ((self.iter // cc.MAP_every) + 1) * cc.MAP_every, cc.maxiters)
            self._run_chunk(boundary - self.iter, accept_all=self.spec.MH)
            if self.iter % cc.MAP_every == 0 or self.iter >= cc.maxiters:
                self._map_check()

        # ---- post-warmup MH inference phase ------------------------------
        if self.spec.MH:
            t1 = time.time()
            self.time["warmup"] = (t1 - t0) / 60.0
            self.logger.log(
                f"Warmup done, sampling {self.post_warmup} with MH for "
                "inference", 1)
            done = 0
            while done < self.post_warmup:
                nxt = min(
                    ((self.iter // cc.MAP_every) + 1) * cc.MAP_every,
                    self.iter + (self.post_warmup - done))
                steps = nxt - self.iter
                self._run_chunk(steps, accept_all=False)
                done += steps
                final = done >= self.post_warmup
                if self.iter % cc.MAP_every == 0 or final:
                    self._map_check(final=final)
            self.logger.log(
                f"Additional {self.post_warmup} MH samples done", 1)
            self.time["MH"] = (time.time() - t1) / 60.0
        else:
            self.get_MAP(final=True)
            if self.spec.learning_rank:
                self.logger.log(format_counts_table(self.MAP["A_counts"]), 1)
            self.logger.log("Final MAP computed", 1)

        self.logger.log("Sampler done", 1)
        self.time["total"] = (time.time() - t0) / 60.0
        self.time["per_iter"] = self.time["total"] / self.iter
        self.time["iters_per_sec"] = self.iter / max(self.time["total"] * 60.0,
                                                     1e-9)
        self.logger.log(f"Total time: {round(self.time['total'], 2)} minutes "
                        f"({self.time['iters_per_sec']:.1f} it/s)", 1)
        if self.output_dir:
            self.logger.log("Saving final object", 1)
            self.save_object()
        return self

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------

    def save_object(self, path: Optional[str] = None):
        from ..utils.checkpoint import save_sampler

        path = path or (os.path.join(self.output_dir, "sampler.ckpt")
                        if self.output_dir else "sampler.ckpt")
        save_sampler(self, path)
        return path

    @classmethod
    def load(cls, path: str, mesh=None):
        from ..utils.checkpoint import load_sampler

        return load_sampler(cls, path, mesh=mesh)

    # ------------------------------------------------------------------
    # postprocessing entry points
    # ------------------------------------------------------------------

    def assign_signatures_ensemble(self, reference_P="cosmic", idxs=None,
                                   credible_interval=0.95):
        from ..utils.postprocessing import assign_signatures_ensemble

        return assign_signatures_ensemble(
            self, reference_P=reference_P, idxs=idxs,
            credible_interval=credible_interval)

    def summary(self, reference_P="cosmic"):
        from ..utils.postprocessing import sampler_summary

        return sampler_summary(self, reference_P=reference_P)

    def plot(self, **kw):
        from ..utils.plotting import plot_sampler

        return plot_sampler(self, **kw)


# ---------------------------------------------------------------------------
# top-level driver — maps C1 (bayesNMF, bayesNMF.R:24-138)
# ---------------------------------------------------------------------------


def fit(
    data,
    rank,
    likelihood: str = "poisson",
    prior: str = "truncnormal",
    rank_method: str = "SBFI",
    MH: Optional[bool] = None,
    convergence_control: Optional[ConvergenceControl] = None,
    output_dir: Optional[str] = "default",
    parallel_bic: bool = True,
    **kw,
):
    """Fit Bayesian NMF; the device-resident ``bayesNMF()``.

    With a scalar rank or rank_method SBFI/BFI this runs one sampler; with
    rank_method='BIC' it fits one model per candidate rank and returns
    {results, best_rank, sampler} picking the min final BIC (bayesNMF.R:66-126).

    The BIC search runs all candidate ranks SIMULTANEOUSLY as one vmapped
    device program by default (``parallel_bic=True``): rank k becomes a chain
    of the max-rank model with the inclusion vector fixed to k ones, whose
    excluded columns sample from the prior exactly like the reference's
    A_n = 0 dispatch (sample_Pn.R:12-13) — identical in distribution to a
    dedicated rank-k fit, at the wall-clock cost of ONE fit instead of the
    reference's serial lapply over ranks (bayesNMF.R:67-105).
    ``parallel_bic=False`` restores the serial per-rank loop (one
    GibbsSampler and output dir per rank).

    ``output_dir`` defaults to ``nmf_<likelihood>_<prior>`` like the reference
    (bayesNMF.R:33); pass ``None`` to disable logging/checkpointing entirely
    (a capability the R API lacks).
    """
    if output_dir == "default":
        output_dir = f"nmf_{likelihood}_{prior}"
    learning = not isinstance(rank, (int, np.integer)) and len(list(rank)) > 1
    if learning and rank_method == "BIC" and parallel_bic:
        from ..parallel.ensemble import ChainEnsemble

        # every GibbsSampler option is also a ChainEnsemble option
        # (tests/test_ensemble_surface.py pins this), so **kw passes through
        ranks = sorted(int(r) for r in rank)
        N = max(ranks)
        masks = np.zeros((len(ranks), N), np.float32)
        for c, k in enumerate(ranks):
            masks[c, :k] = 1.0
        ens = ChainEnsemble(
            data, N, n_chains=len(ranks), likelihood=likelihood,
            prior=prior, MH=MH, convergence_control=convergence_control,
            output_dir=output_dir, A_masks=masks, **kw)
        ens.run()
        table = ens.bic_table()
        results = [{"rank": int(r["rank"]), "chain": int(r["chain"]),
                    "dir": ens.output_dir, "BIC": float(r["BIC"]),
                    "time": ens.time["total"]}
                   for _, r in table.iterrows()]
        best_chain = int(table.iloc[0]["chain"])
        return {"results": results,
                "best_rank": int(table.iloc[0]["rank"]),
                "sampler": ens.chain(best_chain), "ensemble": ens}
    if learning and rank_method == "BIC":
        results = []
        best = None
        for k in sorted(int(r) for r in rank):
            od_k = os.path.join(output_dir, f"rank_{k}") if output_dir else None
            s = GibbsSampler(
                data, k, likelihood=likelihood, prior=prior,
                rank_method=rank_method, MH=MH,
                convergence_control=convergence_control, output_dir=od_k, **kw)
            s.run_gibbs_sampler()
            bic_k = s.MAP_metrics[-1]["BIC"]
            results.append({"rank": k, "dir": od_k, "BIC": bic_k,
                            "time": s.time["total"]})
            if best is None or bic_k < best[0]:
                best = (bic_k, k, s)
        results.sort(key=lambda r: r["BIC"])
        if output_dir:
            # save the winning sampler at the parent level (bayesNMF.R:125)
            best[2].save_object(os.path.join(output_dir, "sampler.ckpt"))
        return {"results": results, "best_rank": best[1], "sampler": best[2]}

    sampler = GibbsSampler(
        data, rank, likelihood=likelihood, prior=prior,
        rank_method=rank_method, MH=MH,
        convergence_control=convergence_control, output_dir=output_dir, **kw)
    return sampler.run_gibbs_sampler()
