"""BLUEProblem: the user-facing orchestration class.

Keeps the reference API surface (blue_models.py:42-978) -- construction
runs pilot covariance/cost estimation, ``setup_*`` methods run allocation
optimization, ``solve*`` methods run the sampling loop and assemble the
estimators -- with the internals rebuilt as JAX programs:

  * model graphs    -> mask-based CovarianceGraph (graph/covariance.py)
  * networkx        -> bitmask cliques (graph/cliques.py)
  * cvxopt/cvxpy    -> JAX interior-point SDP (solvers/sdp.py)
  * spg.py          -> on-device SPG + eigh projection (linalg/)
  * mpi4py blue_fn  -> vmapped/shard_mapped device engine with psum
                       (sampling/jax_engine.py), host loop for black-box
                       models (sampling/host_engine.py)

There is no rank-0/broadcast asymmetry: computation is single-controller
(JAX) and every process sees the same results by construction.
"""

from __future__ import annotations

import os
from contextlib import nullcontext as _nullcontext
from time import time
from typing import Optional

import jax
import numpy as np

from .allocation import MOSAP, BLUESTError
from .estimators.closed_forms import (mlmc_allocation, mlmc_bounds_batch,
                                      mfmc_allocation, mfmc_check)
from .graph import CovarianceGraph, cliques
from .linalg.spd import (mark_uncorrelated, project_covariance_full,
                         project_covariance_masked)
from .parallel.mesh import sample_mesh
from .progress import rate_eta as progress_rate_eta
from .sampling import host_engine, jax_engine

spg_default_params = {
    "maxit": 10000,
    "max_fevals": 10000 ** 2,
    "verbose": False,
    "spd_threshold": 5.0e-14,
    "eps": 1.0e-10,
    "lmbda_min": 10.0 ** -30,
    "lmbda_max": 10.0 ** 30,
    "linesearch_history_length": 10,
}

default_params = {
    "verbose": True,
    "comm": None,                      # accepted for API compat; unused
    "remove_uncorrelated": True,
    "optimization_solver": "sdp",
    "covariance_estimation_samples": 100,
    "sample_batch_size": 1,
    "samplefile": None,
    "outputs_to_save": None,
    "skip_projection": False,
    "spg_params": spg_default_params,
    # additions over the reference API
    "seed": 0,
    "mesh": None,                      # None | "auto" | jax.sharding.Mesh
    "device_batch_size": 4096,
    "max_resample": 64,                # 0 = model guaranteed finite
    "host_workers": 1,                 # >1: process pool for black-box models
    "model_workers": 1,                # >1: processes per model evaluation
                                       # (nested parallelism via get_comm)
    "profile_dir": None,               # jax.profiler.trace dir for solve()
}


def _dv_fold(D: np.ndarray) -> np.ndarray:
    """Fold finite MLMC-variance entries onto both triangles.

    ``dV`` is consumed at ``(min(i,j), max(i,j))`` -- the upper triangle
    (reference blue_models.py:625-629).  A user-supplied matrix filled
    below the diagonal, or a finite entry moved there by a node
    reordering, would silently never be read; folding makes the value
    visible from either triangle (the original entry wins when both are
    finite)."""
    D = np.array(D, dtype=float)
    return np.where(np.isfinite(D), D, D.T)


class BLUEProblem:
    def __init__(self, M: int, C=None, costs=None, mlmc_variances=None,
                 datafile: Optional[str] = None, n_outputs: int = 1,
                 **params):
        """See reference blue_models.py:43-103.  ``C`` entries: NaN =
        estimate from pilot samples, inf = models never coupled, 0 = known
        uncorrelated, finite = known covariance."""
        self.M = M
        self.n_outputs = n_outputs

        self.MOSAP = None
        self.MOSAP_output = None

        self.default_params = default_params
        self.params = default_params.copy()
        spg_params = spg_default_params.copy()
        spg_params.update(params.get("spg_params", {}))
        params["spg_params"] = spg_params
        self.params.update(params)

        self.verbose = self.params["verbose"]
        self.warning = True

        mesh = self.params["mesh"]
        if mesh == "auto":
            mesh = sample_mesh() if len(jax.devices()) > 1 else None
        self.mesh = mesh
        self._engines = {}
        self._base_key = jax.random.key(self.params["seed"])
        self._call_counter = 0
        # per-group sampling telemetry: {group: {"samples", "wall_s"}}
        self.sampling_stats = {}

        if C is None:
            C = [np.nan * np.ones((M, M)) for _ in range(n_outputs)]
        if mlmc_variances is None:
            dV = [np.nan * np.ones((M, M)) for _ in range(n_outputs)]
        else:
            dV = mlmc_variances

        if datafile is not None:
            self.load_graph_data(datafile, costs)
            self.check_costs(warning=True)
        else:
            if not isinstance(C, (list, tuple)):
                C = [C]
            if not isinstance(dV, (list, tuple)):
                dV = [dV]
            for n in range(n_outputs):
                Cn = np.asarray(C[n], dtype=float)
                if Cn.shape != (M, M):
                    raise ValueError(
                        "C[%d] has shape %s; expected (M, M) = (%d, %d)"
                        % (n, Cn.shape, M, M))
            if costs is not None:
                w = np.asarray(costs, dtype=float)
                if w.shape != (M,):
                    raise ValueError(
                        "costs has shape %s; expected (M,) = (%d,)"
                        % (w.shape, M))
                if not np.all(np.isfinite(w)) or np.any(w <= 0):
                    raise ValueError(
                        "model costs must be finite and positive, got %s"
                        % w)
            self.G = [CovarianceGraph(np.array(C[n], dtype=float))
                      for n in range(n_outputs)]
            self.SG = [list(range(M)) for _ in range(n_outputs)]
            self.dV = [_dv_fold(dVn) for dVn in dV]
            self.costs = (None if costs is None
                          else np.asarray(costs, dtype=float))

            if self.costs is None:
                self.estimate_costs()
            self.check_costs(warning=True)

            self.estimate_missing_covariances(
                int(self.params["covariance_estimation_samples"]))
            if not self.params["skip_projection"]:
                self.project_covariances()

            self.check_graphs(
                remove_uncorrelated=self.params["remove_uncorrelated"])

        if self.verbose:
            print("\nBLUE estimator ready.\n")

    # ---------------- functions to be overloaded by the user ----------- #

    def evaluate(self, ls, samples, N=1):
        """Black-box evaluation: returns Ps[n][i] for output n, model ls[i]
        (reference blue_models.py:108-110)."""
        raise NotImplementedError

    def sampler(self, ls, N=1):
        """Black-box input sampler (reference blue_models.py:113-115)."""
        raise NotImplementedError

    def sampler_jax(self, key, ls):
        """JAX-traceable sampler: key -> coupled samples for models ls.
        Override together with evaluate_jax to enable the device engine."""
        raise NotImplementedError

    def evaluate_jax(self, ls, samples):
        """JAX-traceable evaluation: returns an (n_outputs, len(ls)) array."""
        raise NotImplementedError

    def sample_input_jax(self, key):
        """JAX-traceable *factored* sampler: key -> random input theta,
        shared by every model of a coupled group.  Override together with
        evaluate_model_jax for the kernel engine (one compiled kernel per
        model instead of one per group -- much cheaper cold start)."""
        raise NotImplementedError

    def evaluate_model_jax(self, l, theta):
        """JAX-traceable single-model evaluation: returns the (n_outputs,)
        output vector of model ``l`` on input ``theta``."""
        raise NotImplementedError

    def get_models_inner_products(self):
        return [lambda a, b: a * b for _ in range(self.n_outputs)]

    def get_comm(self):
        """Intra-group communicator for internally-parallel black-box
        models (reference blue_models.py:121-130): with
        ``params['model_workers'] > 1`` each model evaluation owns a
        group of processes and this returns its
        :class:`~bluest_tpu.parallel.hostcomm.HostComm`; ``None`` for
        JAX models (distribution is the device mesh) and single-process
        sampling."""
        return getattr(self, "_host_comm", None)

    # --------------------------- utilities ----------------------------- #

    def _has_jax_model(self) -> bool:
        cls = type(self)
        return ((cls.evaluate_jax is not BLUEProblem.evaluate_jax
                 and cls.sampler_jax is not BLUEProblem.sampler_jax)
                or self._has_factored_jax_model())

    def _has_factored_jax_model(self) -> bool:
        cls = type(self)
        return (cls.evaluate_model_jax is not BLUEProblem.evaluate_model_jax
                and cls.sample_input_jax is not BLUEProblem.sample_input_jax)

    def get_costs(self) -> np.ndarray:
        return np.asarray(self.costs, dtype=float)

    def get_group_costs(self, groups):
        model_costs = self.get_costs()
        return np.array([model_costs[list(g)].sum()
                         for gk in groups for g in gk])

    def check_costs(self, warning: bool = True):
        costs = self.get_costs()
        worse = []
        if costs[0] != costs.max():
            worse = list(np.where(costs > costs[0])[0])
            msg = ("Model zero is not the most expensive model. The more "
                   "expensive models are: %s" % worse)
            if warning:
                if self.verbose:
                    print("WARNING! " + msg)
            else:
                raise ValueError(msg)
        return worse

    def get_mlmc_variances(self):
        return self.dV

    def get_mlmc_variance(self, n=0):
        return self.dV[n]

    def get_covariances(self):
        return [self.get_covariance(n) for n in range(self.n_outputs)]

    def get_covariance(self, n=0) -> np.ndarray:
        return self.G[n].covariance()

    def get_correlations(self):
        return [self.get_correlation(n) for n in range(self.n_outputs)]

    def get_correlation(self, n=0) -> np.ndarray:
        return self.G[n].correlation()

    def outer(self, a, b, inner):
        L = len(a)
        out = np.zeros((L, L))
        for i in range(L):
            for j in range(L):
                out[i, j] = inner(a[i], b[j])
        return out

    def get_model_graph(self, C, costs=None):
        """Model graph from a (possibly partial) covariance (reference
        blue_models.py:232-263).  Returns a CovarianceGraph -- the
        sentinel semantics (NaN = estimate, inf = never couple,
        0 = uncorrelated) match the reference; the networkx object is
        replaced by the mask-based graph the device kernels consume.
        Like the reference (which stores costs as node attributes), the
        optional ``costs`` are attached to the returned graph, not to
        the problem."""
        C = np.array(C, dtype=float)
        G = CovarianceGraph(C)
        if costs is not None:
            costs = np.asarray(costs, dtype=float)
            if costs.shape != (C.shape[0],):
                raise ValueError("costs must have one entry per model")
            G.costs = costs
        return G

    # ------------------------ graph manipulation ----------------------- #

    def reorder_all_graph_nodes(self, ordering=None):
        for n in range(self.n_outputs):
            self.reorder_graph_nodes(n, ordering=ordering,
                                     _part_of_all=True)

    def reorder_graph_nodes(self, n=0, ordering=None, _part_of_all=False):
        M = self.M
        if ordering is None or (isinstance(ordering, str) and "asc" in ordering):
            p = np.arange(M)
        elif isinstance(ordering, str) and "desc" in ordering:
            p = np.arange(M)[::-1]
        elif isinstance(ordering, (list, np.ndarray)) and len(ordering) == M:
            p = np.asarray(ordering, dtype=int)
        else:
            raise ValueError("ordering must be None, 'asc', 'desc' or a "
                             "permutation of the model indices")
        # costs are shared across outputs and permuted once (at n == 0);
        # permuting a single output's graph would silently desync the
        # others from the shared costs (n != 0: that graph from the
        # costs; n == 0 with several outputs: the costs from every other
        # graph) -- only reorder_all_graph_nodes may permute directly
        if (not _part_of_all and not np.array_equal(p, np.arange(M))
                and (n != 0 or self.n_outputs > 1)):
            raise ValueError(
                "reordering a single output graph (n=%d) would desync the "
                "shared model costs; use reorder_all_graph_nodes" % n)
        self.G[n].permute(p)
        # the clique-enumeration universe must follow the relabeling, or
        # setup_solver keeps enumerating over pre-permutation labels
        self.SG[n] = list(self.G[n].component)
        self.dV[n] = _dv_fold(self.dV[n][np.ix_(p, p)])
        if n == 0:
            self.costs = self.costs[p]

    def save_graph_data(self, filename: str):
        """Reference-format npz (blue_models.py:265-271)."""
        C_dict = {"C%d" % n: self.G[n].adjacency()
                  for n in range(self.n_outputs)}
        np.savez(filename, M=self.M, n_outputs=self.n_outputs,
                 costs=self.get_costs(), **C_dict,
                 SG=np.array(self.SG, dtype=object), dV=np.array(self.dV))

    def load_graph_data(self, filename: str, costs=None):
        """(blue_models.py:273-299); loads reference-produced files too."""
        data = dict(np.load(filename, allow_pickle=True))
        if self.M != int(data["M"]) or self.n_outputs > int(data["n_outputs"]):
            raise ValueError("Loaded data model/output count mismatch")
        self.G = [CovarianceGraph.from_adjacency(data["C%d" % n])
                  for n in range(self.n_outputs)]
        self.costs = (np.asarray(costs, dtype=float) if costs is not None
                      else np.asarray(data["costs"], dtype=float))
        self.SG = [list(sg) for sg in data["SG"]][:self.n_outputs]
        dV = data.get("dV", None)
        if dV is None:
            self.dV = [np.nan * np.ones((self.M, self.M))
                       for _ in range(self.n_outputs)]
        else:
            self.dV = [_dv_fold(dV[n]) for n in range(self.n_outputs)]

    def check_graphs(self, remove_uncorrelated: bool = False):
        for n in range(self.n_outputs):
            self.check_graph(n, remove_uncorrelated=remove_uncorrelated)

    def check_graph(self, n=0, remove_uncorrelated: bool = False):
        warn = (lambda m: print("WARNING! " + m)) if self.verbose else None
        self.G[n].check(remove_uncorrelated=remove_uncorrelated, warn=warn)
        self.SG[n] = self.G[n].component

    def _intersection_adjacency(self) -> np.ndarray:
        adj = self.G[0].clique_adjacency().copy()
        for n in range(1, self.n_outputs):
            adj &= self.G[n].clique_adjacency()
        return adj

    # ---------------- covariance and cost estimation ------------------- #

    def estimate_missing_covariances(self, N: int):
        """(blue_models.py:326-346)"""
        ls = sorted(set().union(*[set(self.G[n].missing_rows())
                                  for n in range(self.n_outputs)]))
        if len(ls) == 0:
            return
        if self.verbose:
            print("Covariance estimation with %d samples..." % N)
        sumse, sumsc, cost, sumsd1, sumsd2 = self.blue_fn(
            ls, N, compute_mlmc_differences=True)
        inners = self.get_models_inner_products()
        C_hat = [np.asarray(sumsc[n]) / N
                 - self.outer(sumse[n], sumse[n], inners[n]) / N ** 2
                 for n in range(self.n_outputs)]

        for n in range(self.n_outputs):
            for a in range(len(ls)):
                for b in range(a + 1, len(ls)):
                    i, j = ls[a], ls[b]
                    if not np.isfinite(self.dV[n][i, j]):
                        d1 = np.asarray(sumsd1[n][a][b]) / N
                        self.dV[n][i, j] = (np.asarray(sumsd2[n][a][b]) / N
                                            - inners[n](d1, d1))

        for n in range(self.n_outputs):
            g = self.G[n]
            for a in range(len(ls)):
                for b in range(a, len(ls)):
                    i, j = ls[a], ls[b]
                    if g.edges[i, j] and g.unknown[i, j]:
                        denom = np.sqrt(C_hat[n][a, a] * C_hat[n][b, b])
                        rho = C_hat[n][a, b] / denom if denom > 0 else 0.0
                        g.set_estimated(i, j, C_hat[n][a, b], rho)

    def project_covariances(self, bypass_error_check: bool = False):
        for n in range(self.n_outputs):
            self.project_covariance(n, bypass_error_check=bypass_error_check)

    def project_covariance(self, n=0, bypass_error_check: bool = False):
        """(blue_models.py:348-433).  Divergence: the large-error early
        return is gated only on ``bypass_error_check`` (the reference also
        gates it on verbosity, blue_models.py:401)."""
        spg_params = self.params["spg_params"]
        spd_eps = spg_params["spd_threshold"]
        C = self.get_covariance(n)

        if np.isfinite(C).all():
            C_new, err = project_covariance_full(C, spd_eps)
            if self.verbose:
                print("Covariance projected to be SPD, error:", err)
        else:
            if self.verbose:
                print("Running spectral projected gradient for covariance "
                      "projection...")
            mask = (~np.isnan(C)).astype(float)
            C_new, err, res = project_covariance_masked(
                C, mask, spd_eps=spd_eps, spg_eps=spg_params["eps"],
                maxit=spg_params["maxit"],
                max_fevals=spg_params["max_fevals"],
                lmbda_min=spg_params["lmbda_min"],
                lmbda_max=spg_params["lmbda_max"],
                history=spg_params["linesearch_history_length"])
            if int(res.solver_info) == 0:
                if self.verbose:
                    print("Covariance projected, projection error:", err)
                if err > spg_params["eps"] and not bypass_error_check:
                    if self.verbose:
                        print("\nWARNING! Large covariance projection error."
                              " Model covariance may be singular; consider "
                              "removing a model. Leaving covariances as "
                              "they are (bypass with "
                              "project_covariances(bypass_error_check="
                              "True)).\n")
                    return err
            else:
                raise RuntimeError("Covariance projection did not converge: "
                                   "%s" % (res,))
            C_new = mark_uncorrelated(C_new, keep_nan_mask=np.isnan(C))

        self.G[n].apply_projection(C_new)
        return err

    def estimate_costs(self, N: int = 1):
        """Wall-time cost estimation (blue_models.py:435-441)."""
        if self.verbose:
            print("Cost estimation via sampling...")
        self.costs = np.zeros(self.M)
        for l in range(self.M):
            self.blue_fn([l], 1, verbose=False)       # warm-up / compile
            t0 = time()
            _, _, cost = self.blue_fn([l], N, verbose=False)
            wall = time() - t0
            self.costs[l] = (cost if cost > 0 else wall) / N

    # ----------------------------- engine ------------------------------ #

    def __getstate__(self):
        # drop unpicklable device state so black-box problems can be
        # shipped to worker processes (host_engine.blue_fn_parallel)
        state = self.__dict__.copy()
        for k in ("_engines", "_kengine", "mesh", "_base_key", "MOSAP",
                  "MOSAP_output"):
            state.pop(k, None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._engines = {}
        self._kengine = None
        self.mesh = None
        self.MOSAP = None
        self.MOSAP_output = None
        # lazy: black-box sampling workers must not initialize a JAX
        # backend (each would grab the accelerator) just to hold a key
        self._base_key = None

    def _ensure_base_key(self):
        if self._base_key is None:
            self._base_key = jax.random.key(self.params.get("seed", 0))
        return self._base_key

    def blue_fn(self, ls, N, verbose=True, compute_mlmc_differences=False):
        if self._has_jax_model():
            return self._blue_fn_device(ls, N, compute_mlmc_differences)
        # host models under jax.distributed run redundantly per process
        # (same seed -> same samples); keep the rank-0 snapshot-write
        # discipline so processes sharing a filesystem can't race on the
        # npz (device engines get this via _collect_sink's NullSink)
        samplefile = (self.params["samplefile"]
                      if jax.process_index() == 0 else None)
        n_workers = int(self.params.get("host_workers", 1))
        model_workers = int(self.params.get("model_workers", 1))
        if n_workers > 1 or model_workers > 1:
            return host_engine.blue_fn_parallel(
                ls, N, self, n_workers, No=self.n_outputs,
                compute_mlmc_differences=compute_mlmc_differences,
                model_workers=model_workers,
                filename=samplefile,
                outputs_to_save=self.params["outputs_to_save"])
        return host_engine.blue_fn(
            ls, N, self, sampler=self.sampler,
            inners=self.get_models_inner_products(),
            N1=self.params["sample_batch_size"], No=self.n_outputs,
            verbose=self.verbose and verbose,
            compute_mlmc_differences=compute_mlmc_differences,
            filename=samplefile,
            outputs_to_save=self.params["outputs_to_save"])

    def _kernel_engine(self, precompile: bool = True):
        if getattr(self, "_kengine", None) is None:
            from .sampling.kernel_engine import KernelEngineV2
            self._kengine = KernelEngineV2(
                self.sample_input_jax, self.evaluate_model_jax, self.M,
                self.n_outputs,
                batch_size=int(self.params["device_batch_size"]),
                mesh=self.mesh,
                # optional natively-batched model supplied by the user:
                # fn(l, thetas) -> (B, No)
                eval_model_batched_fn=getattr(
                    self, "evaluate_model_jax_batched", None))
            # compile all model kernels concurrently up front (XLA releases
            # the GIL, and the persistent cache removes it on reruns).
            # A samplefile run dispatches the theta-returning sweep
            # variant -- warm it too or its compile lands mid-solve.
            # precompile=False builds the engine only (for callers that
            # drive single sweeps).
            if precompile:
                self._kengine.precompile(
                    parallel=True,
                    collect=self.params.get("samplefile") is not None)
        return self._kengine

    def _group_batch(self, N):
        # the engine is cached per group and reused for every later N, so
        # the batch must NOT be clamped to the first call's N: a pilot
        # blue_fn(g, 1) would pin batch_size=1 and a later N=1e5 solve on
        # the same group would scan one sample at a time.  A small-N call
        # at full batch just masks the padding lanes (idx < N).
        del N
        return max(1, int(self.params["device_batch_size"]))

    def _group_engine(self, key_ls, N):
        if key_ls not in self._engines:
            model_fn = jax_engine.make_model_fn(
                self.sampler_jax, self.evaluate_jax, key_ls)
            self._engines[key_ls] = jax_engine.build_group_engine(
                model_fn, self.n_outputs, len(key_ls),
                batch_size=self._group_batch(N), mesh=self.mesh,
                max_resample=int(self.params["max_resample"]))
        return self._engines[key_ls]

    def _device_dispatch(self, ls, N):
        """Enqueue one group's sampling reduction without synchronizing.

        JAX dispatch is asynchronous: returning the device-side SampleSums
        lets the solve loop enqueue EVERY group before the first host
        fetch, so per-dispatch latency is paid once per program,
        pipelined, instead of once per group round-trip.
        ``_device_finalize`` does the host fetch + non-finite top-up."""
        key_ls = tuple(int(l) for l in ls)
        key = jax.random.fold_in(self._ensure_base_key(), self._call_counter)
        self._call_counter += 1
        t0 = time()
        if self._has_factored_jax_model():
            samplefile = self.params["samplefile"]
            if samplefile is not None and int(N) > 0:
                # same N > 0 guard as the group branch below: a
                # zero-sample collect run has nothing to snapshot
                sums = self._kernel_collect_run(key_ls, key, int(N),
                                                samplefile)
            else:
                sums = self._kernel_engine().sample_sums(key_ls, key, int(N))
        else:
            samplefile = self.params["samplefile"]
            if samplefile is not None and int(N) > 0:
                # snapshot-collecting group engine (reference streams
                # snapshots on EVERY path, blue_fn.py:133-145; this was a
                # silent no-op through round 2 -- VERDICT r2 item 3)
                sums = self._group_collect_run(key_ls, key, int(N),
                                               samplefile)
            else:
                sums = self._group_engine(key_ls, N)(key, int(N))
        return key_ls, sums, t0

    # snapshot collection buffers every sample's outputs + raw inputs on
    # device; bound the allocation by flushing to the npz in chunks (the
    # non-collect engine runs in O(batch) memory -- a 5e6-sample run must
    # not suddenly need gigabytes just because samplefile is set)
    _COLLECT_CHUNK = 1 << 18
    # XL runs above this many bytes of collected rows switch from
    # accumulate-on-host to an async disk spool (SnapshotSpool): chunks
    # stream to temp files from a writer thread overlapped with device
    # sampling, and the final npz write pages from memmaps.  Env override
    # BLUEST_TPU_SNAPSHOT_SPILL_MB (0 disables spilling).
    _COLLECT_SPILL_BYTES = 256 << 20

    def _collect_spill_bytes(self):
        mb = os.environ.get("BLUEST_TPU_SNAPSHOT_SPILL_MB")
        if mb is not None:
            try:
                v = float(mb)
            except ValueError:     # malformed: keep the default, don't
                v = None           # abort a long sampling run mid-flight
            if v is not None:
                return v * 2 ** 20 if v > 0 else float("inf")
        return float(self._COLLECT_SPILL_BYTES)

    def _collect_sink(self, key_ls, N, samplefile):
        """Accumulate-or-spill sink for snapshot collection: chunks stay
        on the host until the projected run volume crosses the spill
        threshold, then stream to an async disk spool living next to the
        samplefile (the system temp dir is often RAM-backed tmpfs, which
        would defeat the memory bound)."""
        from .sampling import snapshots
        if jax.process_index() != 0:
            # multi-process run: every process participates in the
            # engine's replicating gather (a collective), but only
            # process 0 accumulates and writes the samplefile --
            # concurrent appends to one npz on a shared filesystem race
            # (reference rank-0 merge, blue_fn.py:189-222)
            return snapshots.NullSink()
        sdir = os.path.dirname(os.path.abspath(samplefile)) or None
        return snapshots.CollectSink(
            self.n_outputs, len(key_ls), N, self._collect_spill_bytes,
            outputs_to_save=self.params["outputs_to_save"], tmpdir=sdir)

    def _kernel_collect_run(self, key_ls, key, N, samplefile, sink=None):
        """Factored kernel-engine sampling with snapshot collection:
        per-bucket outputs/inputs stream through a CollectSink so XL
        runs stay memory-bounded; returns the SampleSums.  With an
        external ``sink`` the caller owns the write/close (the top-up
        loop batches several small rounds into one npz append)."""
        own = sink is None
        if own:
            sink = self._collect_sink(key_ls, N, samplefile)
        try:
            sums = self._kernel_engine().sample_sums(
                key_ls, key, int(N), collect=True, on_chunk=sink.add)
            if own:
                sink.write(samplefile, key_ls)
        finally:
            if own:
                sink.close()
        return sums

    def _group_collect_run(self, key_ls, key, N, samplefile, sink=None):
        """Run the snapshot-collecting group engine and append the valid
        rows to the samplefile (chunked); returns the summed SampleSums.
        With an external ``sink`` the caller owns the write/close."""
        ckey = (key_ls, "collect")
        if ckey not in self._engines:
            cfn = jax_engine.make_collect_fn(
                self.sampler_jax, self.evaluate_jax, key_ls)
            self._engines[ckey] = jax_engine.build_group_collect_engine(
                cfn, self.n_outputs, len(key_ls),
                batch_size=self._group_batch(N),
                max_resample=int(self.params["max_resample"]))
        engine = self._engines[ckey]
        total = None
        done = 0
        chunk_i = 0
        own = sink is None
        if own:
            sink = self._collect_sink(key_ls, N, samplefile)
        try:
            while done < N:
                n_c = min(self._COLLECT_CHUNK, N - done)
                key_c = (key if chunk_i == 0
                         else jax.random.fold_in(key, 1 << 20 | chunk_i))
                sums, vals, inputs, valid = engine(key_c, n_c)
                sel = np.asarray(valid)
                vals = np.asarray(vals)[sel]
                if vals.ndim == 4 and vals.shape[-1] == 1:
                    vals = vals[..., 0]
                # fetch per chunk (bounds DEVICE memory); the sink
                # appends ONCE at the end (per-chunk npz appends would
                # be quadratic in run length) and bounds HOST memory by
                # spilling XL runs to disk
                sink.add(vals, np.asarray(inputs)[sel], n_c)
                total = sums if total is None else type(sums)(
                    *[a + b for a, b in zip(total[:-1], sums[:-1])],
                    total.n_failed + sums.n_failed)
                done += n_c
                chunk_i += 1
            if own:
                sink.write(samplefile, key_ls)
        finally:
            if own:
                sink.close()
        return total

    def _device_finalize(self, key_ls, N, sums, t0=None,
                         compute_mlmc_differences=False):
        # ``t0 = None``: pipelined callers (dispatch-all first) pass no
        # start time -- a dispatch-time stamp would charge every earlier
        # group's execution to this group's sampling_stats.  The wall
        # recorded here then covers only this group's top-up; the shared
        # dispatch+batched-fetch wall is attributed pro-rata by N in the
        # callers (_attribute_batch_wall), so sampling_stats stays a
        # meaningful per-group cost profile.
        if t0 is None:
            t0 = time()
        # Non-finite samples are masked out of the sums, but the estimator
        # divides by the requested N downstream; top up with fresh batches
        # so the sums really cover N finite samples (the reference resamples
        # until all N are finite, blue_fn.py:118-129).
        samplefile = self.params["samplefile"]
        rounds = 0
        topup_sink = None
        try:
            while int(sums.n_failed) > 0 and rounds < 4:
                deficit = int(sums.n_failed)
                key2 = jax.random.fold_in(self._ensure_base_key(),
                                          self._call_counter)
                self._call_counter += 1
                # top-up samples must reach the snapshot stream too, or
                # the npz rows silently undercount the estimator's N.
                # One sink spans all rounds: a per-round append would
                # re-read + rewrite the group's whole npz each time.
                if samplefile is not None and topup_sink is None:
                    topup_sink = self._collect_sink(key_ls, deficit,
                                                    samplefile)
                if self._has_factored_jax_model():
                    if samplefile is not None:
                        extra = self._kernel_collect_run(
                            key_ls, key2, deficit, samplefile,
                            sink=topup_sink)
                    else:
                        extra = self._kernel_engine().sample_sums(
                            key_ls, key2, deficit)
                elif samplefile is not None:
                    extra = self._group_collect_run(
                        key_ls, key2, deficit, samplefile, sink=topup_sink)
                else:
                    extra = self._group_engine(key_ls, deficit)(key2,
                                                                deficit)
                sums = type(sums)(*[a + b for a, b in
                                    zip(sums[:-1], extra[:-1])],
                                  extra.n_failed)
                rounds += 1
            if topup_sink is not None:
                topup_sink.write(samplefile, key_ls)
        finally:
            if topup_sink is not None:
                topup_sink.close()
        se = np.asarray(sums.sumse)
        if se.ndim == 3 and se.shape[-1] == 1:
            se = se[..., 0]          # scalar outputs: drop the vector dim
        sc = np.asarray(sums.sumsc)
        wall = time() - t0
        st = self.sampling_stats.setdefault(
            key_ls, {"samples": 0, "wall_s": 0.0})
        st["samples"] += int(N)
        st["wall_s"] += wall
        if int(sums.n_failed) > 0 and self.verbose:
            print("WARNING! %d samples non-finite after retries (dropped)"
                  % int(sums.n_failed))
        sumse = [[se[n, i] for i in range(len(key_ls))]
                 for n in range(self.n_outputs)]
        sumsc = [sc[n] for n in range(self.n_outputs)]
        if hasattr(self, "cost"):
            cost = N * self.cost
        else:
            cost = wall
        if compute_mlmc_differences:
            d1 = np.asarray(sums.sumsd1)
            if d1.ndim == 4 and d1.shape[-1] == 1:
                d1 = d1[..., 0]
            d2 = np.asarray(sums.sumsd2)
            sumsd1 = [[[d1[n, i, j] for j in range(len(key_ls))]
                       for i in range(len(key_ls))]
                      for n in range(self.n_outputs)]
            sumsd2 = [[[d2[n, i, j] for j in range(len(key_ls))]
                       for i in range(len(key_ls))]
                      for n in range(self.n_outputs)]
            return sumse, sumsc, cost, sumsd1, sumsd2
        return sumse, sumsc, cost

    def _dispatch_all(self, group_list, n_list):
        """Dispatched list [(key_ls, device_sums, t0) | None] for a
        portfolio of groups.  On the factored kernel-engine path this
        can use the PORTFOLIO fan-out (kernel_engine.portfolio_sums):
        one multi-request sweep per (model, tier) serves every group, so
        the solve portfolio dispatches ~#models programs instead of
        ~sum(len(group)) (VERDICT r5 item 1a).  Keys are allocated per
        group in list order -- the same streams as per-group dispatch,
        so the sums are bit-identical (equivalence-tested).  OPT-IN via
        BLUEST_TPU_PORTFOLIO_SWEEP=1: no steady-state win over the
        per-group path has been shown, so the long-validated per-group
        path stays the default; the H100 comparison is ROADMAP A4."""
        use_portfolio = (self._has_factored_jax_model()
                         and self.params["samplefile"] is None
                         and os.environ.get(
                             "BLUEST_TPU_PORTFOLIO_SWEEP", "0") != "0")
        if not use_portfolio:
            return [self._device_dispatch(g, int(n)) if n > 0 else None
                    for g, n in zip(group_list, n_list)]
        t0 = time()
        reqs, metas = [], []
        for g, n in zip(group_list, n_list):
            if int(n) <= 0:
                metas.append(None)
                continue
            key_ls = tuple(int(l) for l in g)
            key = jax.random.fold_in(self._ensure_base_key(),
                                     self._call_counter)
            self._call_counter += 1
            reqs.append((key_ls, key, int(n)))
            metas.append((key_ls, len(reqs) - 1))
        sums_list = self._kernel_engine().portfolio_sums(reqs)
        return [None if m is None else (m[0], sums_list[m[1]], t0)
                for m in metas]

    def _blue_fn_device(self, ls, N, compute_mlmc_differences=False):
        key_ls, sums, t0 = self._device_dispatch(ls, N)
        return self._device_finalize(key_ls, int(N), sums, t0,
                                     compute_mlmc_differences)

    def _attribute_batch_wall(self, dispatched, n_list, wall):
        """Distribute the shared dispatch+batched-fetch wall across the
        dispatched groups pro-rata by sample count (the sums arrive in
        ONE fetch, so no per-group wall exists to measure)."""
        total = sum(int(n) for d, n in zip(dispatched, n_list)
                    if d is not None)
        if total <= 0:
            return
        for d, n in zip(dispatched, n_list):
            if d is None:
                continue
            st = self.sampling_stats.setdefault(
                d[0], {"samples": 0, "wall_s": 0.0})
            st["wall_s"] += wall * int(n) / total

    def _batch_fetch_sums(self, dispatched):
        """One host fetch for every dispatched group's sums.

        ``jax.device_get`` issues the copies for ALL leaves
        asynchronously before blocking on any, so ~G small transfers
        cost about one round trip instead of G sequential ones.
        Returns host SampleSums aligned
        with ``dispatched`` (None entries preserved)."""
        live = [d[1] for d in dispatched if d is not None]
        if not live:
            return [None] * len(dispatched)
        fetched = iter(jax.device_get(live))
        return [None if d is None else next(fetched) for d in dispatched]

    def _pipelined_sumse(self, group_list, n_list):
        """Per-(group, N) sumse with all device programs enqueued before
        the first host fetch (see the solve loop); None for N == 0."""
        if not self._has_jax_model():
            # host path keeps the per-level progress bar (slow black-box
            # models are exactly where progress output matters)
            return [self.blue_fn(g, int(n))[0] if n > 0
                    else None for g, n in zip(group_list, n_list)]
        t0 = time()
        disp = self._dispatch_all(group_list, n_list)
        host_sums = self._batch_fetch_sums(disp)
        self._attribute_batch_wall(disp, n_list, time() - t0)
        out = []
        for d, hs, n in zip(disp, host_sums, n_list):
            if d is None:
                out.append(None)
                continue
            key_ls, _sums, _t0 = d
            out.append(self._device_finalize(key_ls, int(n), hs)[0])
        return out

    # ----------------------------- solvers ----------------------------- #

    def prewarm_solver(self, K=4, background=False, budget=None,
                       max_model_samples=None):
        """Trace + compile the allocation cone program for the group
        structure a later ``setup_solver(K=...)`` will build, so that
        call skips the per-process trace+lower (~2-3 s at L ~ 400, more
        at large L; the persistent XLA cache only removes the backend
        compile).  Call it while pilot sampling or model warm-up runs;
        ``background=True`` returns immediately and warms in a daemon
        thread.  Pass the ``budget`` / ``max_model_samples`` the later
        solve will use so the matching program form (budget epigraph,
        cap rows) is the one warmed.  Returns the predicted number of
        groups L."""
        K = min(int(K), self.M)
        union = set()
        for n in range(self.n_outputs):
            adj = self.G[n].clique_adjacency()
            for c in cliques.enumerate_cliques(adj, K, nodes=self.SG[n]):
                union.add(tuple(sorted(c)))
        L = len(union)
        from .solvers.sdp import prewarm_mlblue
        from .allocation.mosap import prewarm_forms_for
        from .config import allocation_device_scope
        solver = self.params["optimization_solver"]
        # honor the configured solver: warming the big fused IPM module
        # for a scipy/spg/admm run would pay its compile (and its
        # documented XLA:CPU crash exposure) for a program never used
        forms = prewarm_forms_for(budget, max_model_samples, L,
                                  solver=solver)

        def run():
            # build (and cache) the full MOSAP structure -- psi assembly
            # and invcovs are themselves a chunk of the first-allocation
            # cost, and constructing here lets setup_solver reuse the
            # object via the structure cache
            mos = None
            try:
                mos = self._ensure_mosap(K, None, budget,
                                         max_model_samples, solver)
            except Exception:       # pragma: no cover - prewarm best effort
                pass
            with allocation_device_scope():
                for be, nc in forms:
                    prewarm_mlblue(L, self.n_outputs, self.M + 1,
                                   budget_epigraph=be, n_caps=nc)
                if mos is not None:
                    try:
                        # the solve's other per-process programs: corner
                        # search eigh chunks + cleanup-walk matrices
                        from .solvers.integer import _chunk_var00, _CHUNK
                        eye = np.eye(mos.N)
                        for b in (32, _CHUNK):
                            _chunk_var00(np.broadcast_to(
                                eye, (b, mos.N, mos.N)).copy())
                        for sap in mos.SAPS:
                            sap.get_cleanup_matrix(np.ones(sap.L))
                    except Exception:  # pragma: no cover - best effort
                        pass

        if background:
            import threading
            threading.Thread(target=run, daemon=True).start()
        else:
            run()
        return L

    def _ensure_mosap(self, K, multi_groups, budget, max_model_samples,
                      solver):
        """Build (or reuse from the structure cache) the MOSAP for this
        group configuration.  Shared by ``setup_solver`` and
        ``prewarm_solver`` so prewarming constructs EXACTLY the object
        the solve will use -- psi assembly, invcovs, and the background
        program warms all happen off the timed path when the user calls
        ``prewarm_solver`` during pilot sampling (bench does)."""
        if multi_groups is None:
            Ks = []
            multi_groups = []
            K = min(K, self.M)
            for n in range(self.n_outputs):
                adj = self.G[n].clique_adjacency()
                cl = cliques.enumerate_cliques(adj, K, nodes=self.SG[n])
                by_size = [[] for _ in range(K)]
                for c in cl:
                    by_size[len(c) - 1].append(sorted(c))
                by_size = [b for b in by_size if b]
                multi_groups.append(by_size)
                Ks.append(len(by_size))
            K = max(Ks)
        else:
            mg = []
            Ks = []
            for n in range(self.n_outputs):
                glist = [sorted(list(g)) for g in multi_groups[n]]
                kmax = min(max(len(g) for g in glist), self.M)
                by_size = [[] for _ in range(kmax)]
                adj = self.G[n].clique_adjacency()
                dropped = []
                for g in glist:
                    if (cliques.is_clique(adj, g)
                            and all(v in self.SG[n] for v in g)):
                        by_size[len(g) - 1].append(g)
                    else:
                        dropped.append(g)
                if dropped and self.verbose:
                    # reference behavior: silently filter invalid groups
                    # (blue_models.py:484-486); at least say so
                    print("WARNING! output %d: dropped user groups that "
                          "are not couplable cliques: %s" % (n, dropped))
                mg.append(by_size)
                Ks.append(max(len(g) for b in by_size for g in b) if any(
                    by_size) else 0)
            multi_groups = mg
            K = max(Ks)

        groups = [[] for _ in range(K)]
        for n in range(self.n_outputs):
            for k in range(len(multi_groups[n])):
                for g in multi_groups[n][k]:
                    if g not in groups[k]:
                        groups[k].append(g)
        for k in range(K):
            groups[k].sort()

        C = self.get_covariances()
        costs = self.get_group_costs(groups)
        multi_costs = [self.get_group_costs(item) for item in multi_groups]

        if self.verbose:
            print("Computing optimal sample allocation...")
        # rebuild the MOSAP only when the problem structure changed --
        # repeated setup_solver calls (complexity_test, budget sweeps)
        # otherwise recompile all its jitted variance kernels
        cache_key = (K, tuple(Ks),
                     tuple(np.asarray(Cn).tobytes() for Cn in C),
                     repr(groups), repr(multi_groups), costs.tobytes())
        if (getattr(self, "_mosap_key", None) != cache_key
                or getattr(self, "MOSAP", None) is None):
            # the second clause covers a pickle round trip: __getstate__
            # drops the MOSAP (jitted closures) but _mosap_key survives,
            # so a pure key match would hand the caller MOSAP=None
            from .config import allocation_device_scope
            from .allocation.mosap import prewarm_forms_for
            L_total = sum(len(gk) for gk in groups)
            forms = prewarm_forms_for(budget, max_model_samples, L_total,
                                      solver=solver)
            with allocation_device_scope():
                # psi assembly runs eagerly at construction; keep it off
                # the accelerator (per-op dispatch latency dominates)
                self.MOSAP = MOSAP(C, K, Ks, groups, multi_groups, costs,
                                   multi_costs, verbose=self.verbose,
                                   prewarm_forms=forms)
            self._mosap_key = cache_key
        return self.MOSAP

    def setup_solver(self, K=4, budget=None, eps=None, groups=None,
                     multi_groups=None, solver=None,
                     continuous_relaxation=False, max_model_samples=None,
                     optimization_solver_params=None):
        """(blue_models.py:448-538)"""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if budget is not None and eps is not None:
            eps = None
        if budget is not None and (not np.isfinite(budget) or budget <= 0):
            raise ValueError("budget must be finite and positive, got %s"
                             % budget)
        if eps is not None and np.isscalar(eps):
            eps = [float(eps)] * self.n_outputs
        if eps is not None and any(not np.isfinite(e) or e <= 0
                                   for e in eps):
            raise ValueError("eps tolerances must be finite and positive, "
                             "got %s" % (eps,))
        if multi_groups is None and groups is None and K < 1:
            raise ValueError("K must be >= 1, got %s" % K)
        if solver is None:
            solver = self.params["optimization_solver"]
        if multi_groups is not None and len(multi_groups) != self.n_outputs:
            raise ValueError("multi_groups must have one grouping per output")
        if groups is not None and multi_groups is None:
            multi_groups = [groups for _ in range(self.n_outputs)]

        self._ensure_mosap(K, multi_groups, budget, max_model_samples,
                           solver)
        self.MOSAP.solve(eps=eps, budget=budget, solver=solver,
                         continuous_relaxation=continuous_relaxation,
                         max_model_samples=max_model_samples,
                         solver_params=optimization_solver_params)
        if self.MOSAP.samples is None:
            self.MOSAP_output = None
            raise BLUESTError("MOSAP solution failed!")


        Vs = self.MOSAP.variances(self.MOSAP.samples.astype(float))
        cost_BLUE = self.MOSAP.tot_cost
        C = self.MOSAP.C
        N_MC = max(C[n][0, 0] / Vs[n] for n in range(self.n_outputs))
        cost_MC = N_MC * self.get_costs()[0]
        if self.verbose:
            print("\nBLUE cost:", cost_BLUE, "MC cost:", cost_MC,
                  "Savings:", cost_MC / cost_BLUE)

        self.MOSAP_output = {"budget": budget, "eps": eps,
                             "samples": self.MOSAP.samples,
                             "flattened_groups": self.MOSAP.flattened_groups,
                             "variances": np.asarray(Vs), "cost": cost_BLUE,
                             "certificates": list(self.MOSAP.certificates)}
        if self.verbose and self.MOSAP.certificates:
            best = min(self.MOSAP.certificates,
                       key=lambda cc: max(cc["relgap"], cc["pres"],
                                          cc["dres"]))
            print("SDP certificate [%s]: status=%s relgap=%.2e "
                  "pres=%.2e dres=%.2e (%d iters)"
                  % (best["form"], best["status"], best["relgap"],
                     best["pres"], best["dres"], best["iterations"]))

        sel = np.where(self.MOSAP_output["samples"] > 0)[0]
        which_groups = [self.MOSAP_output["flattened_groups"][i] for i in sel]
        blue_data = {"models": which_groups,
                     "samples": self.MOSAP_output["samples"][sel].copy(),
                     "errors": np.sqrt(np.asarray(Vs)),
                     "total_cost": cost_BLUE}
        if self.verbose:
            print("\nModel groups selected: %s\n" % (which_groups,))
            print("BLUE estimator setup. Max error:",
                  float(np.sqrt(max(Vs))), " Cost:", cost_BLUE, "\n")
        return blue_data

    def solve(self, K=4, budget=None, eps=None, groups=None,
              multi_groups=None, solver=None, verbose=True,
              continuous_relaxation=False, max_model_samples=None,
              optimization_solver_params=None):
        """(blue_models.py:540-576)"""
        if solver is None:
            solver = self.params["optimization_solver"]
        need_setup = self.MOSAP_output is None
        if not need_setup:
            if budget is not None and budget != self.MOSAP_output["budget"]:
                need_setup = True
            if eps is not None and not np.all(
                    np.atleast_1d(eps) == np.atleast_1d(
                        self.MOSAP_output["eps"] if self.MOSAP_output["eps"]
                        is not None else np.nan)):
                need_setup = True
        if need_setup:
            self.setup_solver(K=K, budget=budget, eps=eps, groups=groups,
                              multi_groups=multi_groups, solver=solver,
                              continuous_relaxation=continuous_relaxation,
                              max_model_samples=max_model_samples,
                              optimization_solver_params=optimization_solver_params)
        elif budget is None and eps is None and self.MOSAP_output["cost"] is None:
            raise ValueError("Need to prescribe either a budget or a "
                             "tolerance to run the BLUE estimator")

        if self.verbose and verbose:
            print("\nSampling BLUE...\n")

        flattened_groups = self.MOSAP_output["flattened_groups"]
        sample_list = self.MOSAP_output["samples"]

        # optional on-device profiler trace around the sampling phase
        # (config key: reference-style params dict, SURVEY 5.1)
        trace_dir = self.params.get("profile_dir")
        trace_ctx = (jax.profiler.trace(trace_dir) if trace_dir
                     else _nullcontext())

        n_active = int(sum(1 for N in sample_list if N > 0))
        total_N = int(sum(int(N) for N in sample_list))
        done_groups = 0
        done_N = 0
        t0 = time()
        sums = [[] for _ in range(self.n_outputs)]
        pipelined = self._has_jax_model()
        with trace_ctx:
            # device path: enqueue EVERY group's reduction before the
            # first host fetch -- JAX dispatch is async, so the per-
            # program latency pipelines instead of serializing one
            # round-trip per group
            dispatched = []
            host_sums = []
            if pipelined:
                dispatched = self._dispatch_all(flattened_groups,
                                                sample_list)
                # one batched fetch for every group's sums (see
                # _batch_fetch_sums -- sequential per-group fetches
                # made the estimation wall latency-bound)
                host_sums = self._batch_fetch_sums(dispatched)
                self._attribute_batch_wall(dispatched, sample_list,
                                           time() - t0)
            for gi, (ls, N) in enumerate(zip(flattened_groups,
                                             sample_list)):
                if N == 0:
                    for n in range(self.n_outputs):
                        sums[n].append([0 for _ in range(len(ls))])
                    continue
                if pipelined:
                    key_ls, _dsums, _tg0 = dispatched[gi]
                    sumse, _, _ = self._device_finalize(
                        key_ls, int(N), host_sums[gi])  # t0=None: overlapped
                else:
                    sumse, _, _ = self.blue_fn(ls, int(N), verbose=verbose)
                for n in range(self.n_outputs):
                    sums[n].append(sumse[n])
                done_groups += 1
                done_N += int(N)
                if self.verbose and verbose:
                    if pipelined:
                        # the batched fetch already blocked on ALL
                        # groups' sampling -- a per-group rate/ETA here
                        # would be fiction; these lines are completion
                        # logs and the overall rate prints once below
                        print("  group %s: %d samples | %d/%d groups, "
                              "%d/%d samples"
                              % (list(ls), int(N), done_groups, n_active,
                                 done_N, total_N), flush=True)
                    else:
                        rate, eta = progress_rate_eta(done_N, total_N, t0)
                        print("  group %s: %d samples | %d/%d groups, "
                              "%d/%d samples (%.0f samples/s, ETA %.0fs)"
                              % (list(ls), int(N), done_groups, n_active,
                                 done_N, total_N, rate, eta), flush=True)
            if pipelined and self.verbose and verbose and total_N:
                wall = max(time() - t0, 1e-9)
                print("  estimation: %d samples in %.2fs (%.0f samples/s)"
                      % (total_N, wall, total_N / wall), flush=True)

        mus, Vs = self.MOSAP.compute_BLUE_estimators(sums, sample_list)
        errs = np.sqrt(Vs)
        tot_cost = self.MOSAP_output["cost"]
        return mus, errs, tot_cost

    # ------------------------------ MLMC -------------------------------- #

    def _mlmc_level_data(self, group, n):
        """Telescoped variances/costs for one chain (blue_models.py:688-704)."""
        C = self.get_covariance(n)
        w = self.get_costs()
        subC = C[np.ix_(group, group)]
        subw = w[list(group)].copy()
        if len(group) > 1:
            v = np.diag(subC).copy()
            corrs = np.diag(subC, 1)
            v[:-1] += v[1:] - 2 * corrs
            for i in range(len(group) - 1):
                ii, jj = min(group[i], group[i + 1]), max(group[i], group[i + 1])
                check = self.dV[n][ii, jj]
                if np.isfinite(check):
                    v[i] = check
            subw[:-1] += subw[1:]
        else:
            v = np.array([subC[0, 0]])
        return v, subw

    def _mlmc_chains(self, max_chains: int = 1 << 17):
        """All cost-descending chains through the intersection graph that
        start at model 0 (blue_models.py:662-670).

        The reference enumerates every subset containing model 0 (2^(M-1)
        of them) and filters by path feasibility.  A chain is a
        cost-descending sequence whose consecutive pairs are edges, so the
        same set falls out of a DFS over descending-cost positions that
        abandons a prefix as soon as an edge is missing -- exponentially
        cheaper on sparse coupling graphs, identical output on dense ones.

        Dense graphs past M ~ 17 models would still enumerate 2^(M-1)
        chains; the count is capped at ``max_chains`` (longest/cheapest
        prefixes are explored first by the DFS order) with a warning, so
        setup_mlmc degrades to a wide heuristic search instead of hanging.
        """
        lme = len(self.check_costs(warning=True))
        w = self.get_costs()
        # stable descending sort: reversing an ascending argsort reverses
        # tie order too, so a model tying model 0's cost could land first
        # and trip the assert nondeterministically
        idx = np.argsort(-w, kind="stable")[lme:]
        assert idx[0] == 0
        adj = self._intersection_adjacency()
        n = len(idx)
        groups = []
        stack = [[0]]
        while stack:
            path = stack.pop()
            groups.append([int(idx[p]) for p in path])
            if len(groups) >= max_chains:
                if self.verbose:
                    print("WARNING! MLMC chain enumeration capped at %d "
                          "chains (M = %d is large for a dense coupling "
                          "graph); the chain search is now a heuristic."
                          % (max_chains, self.M))
                break
            last = path[-1]
            for j in range(last + 1, n):
                if adj[idx[last], idx[j]]:
                    stack.append(path + [j])
        return groups

    def _mlmc_level_data_batch(self, G, mask, lengths, n):
        """Vectorized _mlmc_level_data over a padded chain batch.

        G: (B, Lmax) model indices (padded entries 0); mask: validity;
        lengths: (B,) chain lengths.  Returns V, W: (B, Lmax) with the
        same per-level semantics as _mlmc_level_data (pairwise difference
        variances with dV overrides, pairwise costs, singleton tail)."""
        C = self.get_covariance(n)
        w = self.get_costs()
        dV = self.dV[n]
        B, Lmax = G.shape
        Cd = np.diag(C)
        gi = G
        gj = np.concatenate([G[:, 1:], G[:, :1]], axis=1)  # next level
        pair = np.concatenate([mask[:, 1:], np.zeros((B, 1), bool)], axis=1) \
            & mask                                          # l < len-1
        lo = np.minimum(gi, gj)
        hi = np.maximum(gi, gj)
        v_pair = Cd[gi] + Cd[gj] - 2 * C[gi, gj]
        dv = dV[lo, hi]
        v = np.where(np.isfinite(dv), dv, v_pair)
        V = np.where(pair, v, 0.0)
        W = np.where(pair, w[gi] + w[gj], 0.0)
        last = (np.arange(Lmax)[None, :] == (lengths - 1)[:, None])
        V = np.where(last, Cd[gi], V)
        W = np.where(last, w[gi], W)
        return V, W

    def setup_mlmc(self, budget=None, eps=None, continuous_relaxation=False):
        """(blue_models.py:642-741)"""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if budget is not None and eps is not None:
            eps = None
        if eps is not None and np.isscalar(eps):
            eps = [float(eps)] * self.n_outputs
        if eps is None:
            eps = [None] * self.n_outputs

        if self.verbose:
            print("Setting up optimal MLMC estimator...\n")
        if not any(np.isfinite(dVn).any() for dVn in self.dV):
            if self.verbose:
                print("Warning! MLMC variances were not provided nor "
                      "estimated; the MLMC estimator may be suboptimal.\n")

        w = self.get_costs()

        # Pass 1 -- continuous lower bounds, batched over all chains at
        # once (padded (n_chains, Lmax) arrays; see mlmc_bounds_batch for
        # why the eps-mode bound uses the unclamped cost deflated by the
        # integer slack).  Rank chains by max-over-outputs of the bound and
        # stop the expensive corner searches of pass 2 once the bound can
        # no longer beat the incumbent -- exact, not a heuristic.
        chains = self._mlmc_chains()
        B = len(chains)
        Lmax = max(len(g) for g in chains)
        G = np.zeros((B, Lmax), dtype=np.int64)
        mask = np.zeros((B, Lmax), dtype=bool)
        lengths = np.array([len(g) for g in chains])
        for b, g in enumerate(chains):
            G[b, :len(g)] = g
            mask[b, :len(g)] = True
        Vb, Wb = [], []
        bound_all = np.zeros(B)
        feas_all = np.ones(B, dtype=bool)
        # eps-mode bound must be in the SAME cost units as the pass-2
        # incumbent objective: the allocation optimizes pair costs (Wb),
        # but the selection objective and reported total_cost use raw
        # per-model costs (reference convention, blue_models.py:717/726
        # -- kept for paper-golden comparability).  Any variance-feasible
        # schedule's raw cost is bounded below by the raw-cost continuous
        # optimum, so bounding with W_raw keeps the pruning exact.
        Wraw = np.where(mask, w[G], 0.0)
        for n in range(self.n_outputs):
            Vn, Wn = self._mlmc_level_data_batch(G, mask, lengths, n)
            Vb.append(Vn)
            Wb.append(Wn)
            feas_n, bound_n = mlmc_bounds_batch(
                Vn, Wn if budget is not None else Wraw, mask,
                budget=budget, eps=eps[n])
            feas_all &= feas_n & np.isfinite(bound_n)
            bound_all = np.maximum(bound_all, bound_n)
        order = np.argsort(np.where(feas_all, bound_all, np.inf))

        # Pass 2 -- full (integer unless relaxed) allocation in bound order.
        best_group, best_data = None, None
        best_obj = np.inf
        for b in order:
            if not feas_all[b]:
                break
            if bound_all[b] >= best_obj:
                break
            group = chains[b]
            data_list = []
            feasible = True
            for n in range(self.n_outputs):
                v = Vb[n][b, :lengths[b]]
                subw = Wb[n][b, :lengths[b]]
                feasible, data = mlmc_allocation(
                    v, subw, budget=budget, eps=eps[n],
                    continuous_relaxation=continuous_relaxation)
                if not feasible:
                    break
                data_list.append(data)
            if not feasible:
                continue
            if budget is not None:
                obj = max(d["error"] for d in data_list)
            else:
                obj = np.max(np.vstack([d["samples"] for d in data_list]),
                             axis=0) @ w[list(group)]
            if obj < best_obj:
                best_obj, best_group, best_data = obj, group, data_list

        if best_group is None:
            raise BLUESTError("No feasible MLMC chain found")

        samples = np.max(np.vstack([d["samples"] for d in best_data]), axis=0)
        cost = samples @ w[list(best_group)]
        if budget is not None:
            # The per-output schedules each fit the budget, but their
            # element-wise max may not; shrink back onto
            # {m >= 1, m @ w <= budget} by rescaling the free levels (MLMC
            # variance is homogeneous of degree -1 in m, so a uniform
            # rescale degrades every output's error by the same
            # sqrt(cost/budget) factor).  The reference's single additive
            # -w step (blue_models.py:735-738) can dump the whole
            # reduction on a level that is then clamped at 1, leaving the
            # cost far above budget.
            wg = w[list(best_group)]
            m = samples.astype(float)
            for _ in range(len(m) + 1):
                if m @ wg <= budget * (1 + 1e-12):
                    break
                free = m > 1.0
                if not free.any():
                    break
                fixed = m[~free] @ wg[~free]
                scale = (budget - fixed) / (m[free] @ wg[free])
                m[free] = np.maximum(m[free] * max(scale, 0.0), 1.0)
            samples = np.maximum(np.floor(m).astype(np.int64), 1)
            cost = samples @ wg
        errs = [np.sqrt(d["variance"](samples)) for d in best_data]
        mlmc_data = {"models": best_group, "samples": samples,
                     "errors": errs, "total_cost": cost}
        if self.verbose:
            print("Best MLMC estimator found. Coupled models:", best_group,
                  " Max error:", max(errs), " Cost:", cost, "\n")
        return mlmc_data

    def compute_mlmc_data(self, group, samples):
        """User-prescribed MLMC schedule (blue_models.py:578-639)."""
        samples = np.asarray(samples)
        w = self.get_costs()
        adj = self._intersection_adjacency()
        if not cliques.has_path_edges(adj, group):
            raise ValueError("Group given is not compatible with MLMC.")
        if group[0] != 0:
            raise ValueError("The high-fidelity model must lead the group")
        errs = np.zeros(self.n_outputs)
        mlmc_costs = np.zeros(self.n_outputs)
        for n in range(self.n_outputs):
            v, subw = self._mlmc_level_data(group, n)
            pos = samples > 0
            # RMSE, matching setup_mlmc's "errors" units.  The reference
            # returns the VARIANCE here (blue_models.py:633) but the RMSE
            # from setup_mlmc (blue_models.py:732) -- the same key in two
            # different units depending on the path (documented
            # divergence).
            errs[n] = np.sqrt(np.sum(v[pos] / samples[pos]))
            # raw per-model costs, matching setup_mlmc's "total_cost"
            # (the paper-golden convention, blue_models.py:726); the
            # reference prices THIS path with pair costs subw
            # (blue_models.py:635) -- same key, different units again.
            del subw
            mlmc_costs[n] = samples @ w[list(group)]
        return {"models": group, "samples": samples, "errors": errs,
                "total_cost": max(mlmc_costs)}

    def solve_mlmc(self, budget=None, eps=None, mlmc_data=None):
        """(blue_models.py:743-769)"""
        if mlmc_data is None:
            mlmc_data = self.setup_mlmc(budget=budget, eps=eps)
        best_group = mlmc_data["models"]
        samples = np.round(mlmc_data["samples"]).astype(np.int64)
        errs = mlmc_data["errors"]
        tot_cost = mlmc_data["total_cost"]

        if self.verbose:
            print("\nSampling optimal MLMC estimator...\n")
        Lg = len(best_group)
        groups = [list(pair) for pair in zip(best_group[:-1],
                                             best_group[1:])]
        groups += [[best_group[-1]]]
        mu = [0 for _ in range(self.n_outputs)]
        n_list = [int(samples[i]) for i in range(Lg)]
        sumse_list = self._pipelined_sumse(groups, n_list)
        for i in range(Lg):
            N, sumse = n_list[i], sumse_list[i]
            if N == 0:
                continue
            for n in range(self.n_outputs):
                if i < Lg - 1:
                    mu[n] = mu[n] + (sumse[n][0] - sumse[n][1]) / N
                else:
                    mu[n] = mu[n] + sumse[n][0] / N
        return mu, errs, tot_cost

    # ------------------------------ MFMC -------------------------------- #

    def setup_mfmc(self, budget=None, eps=None, continuous_relaxation=False,
                   small_budget=False):
        """(blue_models.py:795-865)"""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if budget is not None and eps is not None:
            eps = None
        if eps is not None and np.isscalar(eps):
            eps = [float(eps)] * self.n_outputs
        if eps is None:
            eps = [None] * self.n_outputs

        sigmas = [np.sqrt(np.diag(self.get_covariance(n)))
                  for n in range(self.n_outputs)]
        rhos = [self.get_correlation(n)[0, :] for n in range(self.n_outputs)]
        w = self.get_costs()
        if self.verbose:
            print("Setting up optimal MFMC estimator...\n")

        adj = self._intersection_adjacency()
        clique_list = [c for c in cliques.enumerate_cliques(adj, self.M)
                       if 0 in c]
        best_group, best_data = None, None
        min_err, min_cost = np.inf, np.inf
        for clique in clique_list:
            clique = sorted(clique)
            data_list = []
            feasible = True
            for n in range(self.n_outputs):
                feasible, data = mfmc_allocation(
                    sigmas[n][clique], rhos[n][clique], w[clique],
                    budget=budget, eps=eps[n],
                    continuous_relaxation=continuous_relaxation,
                    small_budget=small_budget)
                if not feasible:
                    break
                data_list.append(data)
            if not feasible:
                continue
            # schedules and alphas live in |rho|-DESCENDING order (the
            # order MFMC's nesting theory is stated in).  The shared
            # schedule (element-wise max) is only meaningful when every
            # output sorts the clique the same way; the reference merges
            # and prices them in clique order regardless -- silently
            # assigning counts to the wrong models whenever the orders
            # differ (reference blue_models.py:849-856).  Here the group
            # is emitted in a common order: when outputs disagree
            # (near-ties in |rho|, typically), each output's preferred
            # order is tried as the FORCED common order -- the MFMC
            # variance formula is exact for any order, so a forced order
            # whose schedule passes the exact variance/budget validation
            # is still a true MFMC estimator.  Only a clique with no
            # feasible common ordering is skipped.
            order = data_list[0]["order"]
            if any(not np.array_equal(d["order"], order)
                   for d in data_list[1:]):
                best_alt = None
                seen = set()
                for d in data_list:
                    cand = tuple(int(j) for j in d["order"])
                    if cand in seen:
                        continue
                    seen.add(cand)
                    alt = []
                    for n in range(self.n_outputs):
                        okc, dd = mfmc_allocation(
                            sigmas[n][clique], rhos[n][clique], w[clique],
                            budget=budget, eps=eps[n],
                            continuous_relaxation=continuous_relaxation,
                            small_budget=small_budget,
                            order=np.asarray(cand))
                        if not okc:
                            alt = None
                            break
                        alt.append(dd)
                    if alt is None:
                        continue
                    # validate at the MERGED schedule: under a forced
                    # order the variance is increasing in any inverted
                    # coordinate, so the element-wise max can RAISE an
                    # output's variance above its own schedule's -- a
                    # candidate is only acceptable if every output's
                    # tolerance still holds at the merge
                    m_mg = np.max(np.vstack([dd["samples"]
                                             for dd in alt]), axis=0)
                    vs = [dd["variance"](m_mg) for dd in alt]
                    if budget is not None:
                        objv = max(np.sqrt(max(v, 0.0)) for v in vs)
                    else:
                        if any(v > 1.0001 * eps[n] ** 2
                               for n, v in enumerate(vs)):
                            continue
                        objv = m_mg @ w[[clique[j] for j in cand]]
                    if best_alt is None or objv < best_alt[0]:
                        best_alt = (objv, alt, np.asarray(cand))
                if best_alt is None:
                    if self.verbose:
                        print("MFMC: skipping clique %s (no feasible "
                              "common ordering)" % (clique,))
                    continue
                _, data_list, order = best_alt
            sorted_clique = [clique[j] for j in order]
            # rank cliques AT THE MERGED SCHEDULE (what solve_mfmc will
            # actually run).  Per-output own-schedule errors are only an
            # upper bound for consistent-order cliques (the merge adds
            # samples, lowering every variance) but UNDERESTIMATE a
            # rescued clique, where the forced order makes the variance
            # increasing in inverted coordinates -- ranking by them let
            # an optimistic rescued clique beat a genuinely better
            # consistent one.
            m_mg = np.max(np.vstack([d["samples"] for d in data_list]),
                          axis=0)
            if budget is not None:
                err = max(np.sqrt(max(d["variance"](m_mg), 0.0))
                          for d in data_list)
                if err < min_err:
                    min_err = err
                    best_group, best_data = sorted_clique, data_list
            else:
                cost = m_mg @ w[sorted_clique]
                if cost < min_cost:
                    min_cost = cost
                    best_group, best_data = sorted_clique, data_list

        if best_group is None:
            raise BLUESTError("No feasible MFMC clique found")

        samples = np.max(np.vstack([d["samples"] for d in best_data]), axis=0)
        cost = samples @ w[best_group]
        if budget is not None:
            wg = w[best_group]
            samples = np.floor(samples - (max(cost - budget, 0)
                                          / (wg @ wg)) * wg).astype(np.int64)
            # the additive correction can floor later entries to zero or
            # break the m_1 <= m_2 <= ... nesting solve_mfmc divides by;
            # clamp to one sample and restore monotonicity (the reference
            # only clamps samples[0], leaving divide-by-zero NaN means)
            samples = np.maximum.accumulate(np.maximum(samples, 1))
            cost = samples @ wg
        errs = [np.sqrt(d["variance"](samples)) for d in best_data]
        alphas = [d["alphas"] for d in best_data]
        mfmc_data = {"models": best_group, "samples": samples,
                     "errors": errs, "total_cost": cost, "alphas": alphas}
        if self.verbose:
            print("Best MFMC estimator found. Coupled models:", best_group,
                  " Max error:", max(errs), " Cost:", cost, "\n")
        return mfmc_data

    def compute_mfmc_data(self, clique, samples):
        """(blue_models.py:771-793)"""
        sigmas = [np.sqrt(np.diag(self.get_covariance(n)))
                  for n in range(self.n_outputs)]
        rhos = [self.get_correlation(n)[0, :] for n in range(self.n_outputs)]
        w = self.get_costs()
        for n in range(self.n_outputs):
            if not cliques.is_clique(self.G[n].clique_adjacency(), clique):
                raise ValueError("Group given is not a clique of the graph")
        if clique[0] != 0:
            raise ValueError("The high-fidelity model must lead the group")
        data_list = []
        for n in range(self.n_outputs):
            ok, d = mfmc_check(sigmas[n][clique], rhos[n][clique], w[clique],
                               samples)
            if not ok:
                raise ValueError("Prescribed samples infeasible for MFMC")
            data_list.append(d)
        order = data_list[0]["order"]
        if any(not np.array_equal(d["order"], order)
               for d in data_list[1:]):
            raise ValueError("Outputs disagree on the MFMC correlation "
                             "ordering; a shared schedule is ill-defined")
        # models/samples/alphas all in the common |rho|-descending order
        # (what solve_mfmc's nesting consumes; see setup_mfmc)
        return {"models": [clique[j] for j in order],
                "samples": np.asarray(samples)[order],
                "errors": [d["error"] for d in data_list],
                "total_cost": max(d["total_cost"] for d in data_list),
                "alphas": [d["alphas"] for d in data_list]}

    def solve_mfmc(self, budget=None, eps=None, mfmc_data=None,
                   continuous_relaxation=False):
        """(blue_models.py:867-903)"""
        if mfmc_data is None:
            mfmc_data = self.setup_mfmc(budget=budget, eps=eps,
                                        continuous_relaxation=continuous_relaxation)
        best_group = list(mfmc_data["models"])
        samples = np.round(mfmc_data["samples"]).astype(np.int64)
        errs = mfmc_data["errors"]
        tot_cost = mfmc_data["total_cost"]
        alphas = mfmc_data["alphas"]

        if self.verbose:
            print("\nSampling optimal MFMC estimator...\n")
        Lg = len(best_group)
        y = [[0 for _ in range(Lg)] for _ in range(self.n_outputs)]
        y1 = [[0 for _ in range(Lg - 1)] for _ in range(self.n_outputs)]
        n_list = [int(samples[i]) - (int(samples[i - 1]) if i else 0)
                  for i in range(Lg)]
        sumse_list = self._pipelined_sumse(
            [best_group[i:] for i in range(Lg)], n_list)
        for i in range(Lg):
            N, sumse = n_list[i], sumse_list[i]
            if N == 0:
                continue
            for n in range(self.n_outputs):
                for j in range(i, Lg):
                    y[n][j] = y[n][j] + sumse[n][j - i]
                    if j < Lg - 1:
                        y1[n][j] = y1[n][j] + sumse[n][j - i + 1]
        for n in range(self.n_outputs):
            for i in range(Lg):
                y[n][i] = y[n][i] / samples[i]
                if i < Lg - 1:
                    y1[n][i] = y1[n][i] / samples[i]
        mu = [y[n][0] + sum(alphas[n][i] * (y[n][i + 1] - y1[n][i])
                            for i in range(Lg - 1))
              for n in range(self.n_outputs)]
        return mu, errs, tot_cost

    # ------------------------------- MC --------------------------------- #

    def solve_mc(self, budget=None, eps=None):
        """(blue_models.py:905-930)"""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if budget is not None and eps is not None:
            eps = None
        if eps is not None and np.isscalar(eps):
            eps = [float(eps)] * self.n_outputs

        Vs = np.array([self.get_covariance(n)[0, 0]
                       for n in range(self.n_outputs)])
        cost = self.get_costs()[0]
        if budget is not None:
            N_MC = int(np.floor(budget / cost))
        else:
            N_MC = max(int(np.ceil(Vs[n] / eps[n] ** 2))
                       for n in range(self.n_outputs))
        # at least one sample: a budget below one high-fidelity solve
        # would otherwise divide the estimator (and errs) by zero
        N_MC = max(N_MC, 1)
        tot_cost = N_MC * cost
        errs = np.sqrt(np.maximum(Vs, 0.0) / N_MC)
        if self.verbose:
            print("Standard MC estimator ready. Max error:", max(errs),
                  "Cost:", tot_cost)
            print("\nSampling standard MC estimator...\n")
        sumse, _, _ = self.blue_fn([0], N_MC)
        mu = [sumse[n][0] / N_MC for n in range(self.n_outputs)]
        return mu, errs, tot_cost

    # ------------------------- validation tests ------------------------- #

    def complexity_test(self, eps, K=3):
        """(blue_models.py:932-942)"""
        if self.verbose:
            print("Running cost complexity test...")
        tot_cost = []
        for e in eps:
            self.setup_solver(K=K, eps=e)
            tot_cost.append(self.MOSAP_output["cost"])
        tot_cost = np.array(tot_cost)
        rate = np.polyfit(np.arange(len(tot_cost)), np.log2(tot_cost), 1)[0]
        if self.verbose:
            print("Total costs   :", tot_cost)
            print("Estimated rate:", rate)
        return tot_cost, rate

    def variance_test(self, budget=None, eps=None, K=3, N=50, **kwargs):
        """Empirical vs predicted estimator error (blue_models.py:944-978)."""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if budget is not None and eps is not None:
            eps = None
        if eps is not None and np.isscalar(eps):
            eps = [float(eps)] * self.n_outputs

        if self.verbose:
            print("Running variance test...", flush=True)
        # pop BEFORE forwarding: setup_solver takes no verbose kwarg, so
        # passing it through would crash the very call the pop sanitizes
        kwargs.pop("verbose", None)
        self.setup_solver(K=K, budget=budget, eps=eps, **kwargs)
        err_ex = np.sqrt(np.asarray(self.MOSAP_output["variances"]))
        err = np.zeros_like(err_ex)
        inners = self.get_models_inner_products()

        s1 = [0 for _ in range(self.n_outputs)]
        s2 = np.zeros_like(err_ex)
        for it in range(1, N + 1):
            if self.verbose:
                print("Sampling estimator %d/%d" % (it, N), flush=True)
            mus, _, _ = self.solve(K=K, budget=budget, eps=eps,
                                   verbose=False, **kwargs)
            for n in range(self.n_outputs):
                s1[n] += mus[n]
                s2[n] += inners[n](mus[n], mus[n])
        for n in range(self.n_outputs):
            s1[n] = inners[n](s1[n], s1[n]) / N ** 2
            s2[n] /= N
            err[n] = np.sqrt(max(s2[n] - s1[n], 0.0))
        if self.verbose:
            print("Theoretical error: ", err_ex, flush=True)
            print("Estimated error:   ", err, flush=True)
        return err_ex, err
