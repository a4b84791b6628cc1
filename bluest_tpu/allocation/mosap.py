"""Multi-output sample allocation problem (MOSAP).

Rebuild of the reference MOSAP class (mosap.py:18-673): one SAP per output
over that output's group sublist, a shared allocation vector over the union
group list, a joint SDP with one LMI per output, the null-space cleanup
sparsifier, and the multi-output integer projection with its fallback
ladder (cleanup -> tolerance increase -> round up/down)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..config import on_allocation_device
from ..solvers.sdp import solve_cone_lp
from ..solvers.integer import best_integer_blue_multi
from . import cones
from . import certificate as certmod
from .sap import (SAP, _OK_STATUSES, budget_level_bisection, cone_backend,
                  caps_satisfied, validated_nlp_point)


class BLUESTError(RuntimeError):
    """Raised when the allocation optimization fails (reference mosap.py:15)."""


def prewarm_forms_for(budget, max_model_samples, L: int,
                      solver: str = "sdp"):
    """Cone-program shapes -- (budget_epigraph, n_caps) pairs -- that a
    ``MOSAP.solve(budget=..., eps=..., max_model_samples=...)`` call will
    trace, for the constructor's background prewarm (sdp_solve's dispatch
    logic is the source of truth).  n_caps counts the finite per-model
    caps, one Gl row each (get_max_sample_constraints)."""
    if solver not in ("sdp", "cvxopt", "cvxpy"):
        return []          # scipy/spg paths never touch the IPM
    n_caps = 0
    if max_model_samples is not None:
        n_caps = int(np.sum(np.isfinite(
            np.asarray(max_model_samples, dtype=float))))
    if budget is not None:
        # no caps: direct-eps ray + rescale (the epigraph form only runs
        # on the rare ray failure); caps: budget-epigraph with cap rows,
        # then the direct-eps-with-caps bisection whenever the epigraph
        # certificate isn't tight (the common rescue on degenerate sets),
        # whose starting-level probe may solve the 0-cap eps form
        return ([(True, n_caps), (False, n_caps), (False, 0)]
                if n_caps else [(False, 0)])
    forms = [(False, n_caps)]
    if n_caps == 0 and L <= 600:
        # the scaled-epigraph cross-check only races direct-eps at small L
        forms.append((True, 0))
    return forms


class MOSAP:
    def __init__(self, C: Sequence[np.ndarray], K: int, Ks: Sequence[int],
                 groups, multi_groups, costs: np.ndarray,
                 multi_costs: Sequence[np.ndarray], verbose: bool = False,
                 prewarm_forms=None):
        self.verbose = verbose
        self.n_outputs = len(C)
        self.C = [np.asarray(Cn, dtype=float) for Cn in C]
        self.N = self.C[0].shape[0]
        self.K = K
        self.Ks = list(Ks)
        self.costs = np.asarray(costs, dtype=float)
        self.multi_groups = multi_groups
        self.multi_costs = multi_costs

        self.flattened_groups = [list(g) for gk in groups for g in gk]
        self.groups = [np.array(gk, dtype=np.int64).reshape(len(gk), k + 1)
                       for k, gk in enumerate(groups)]
        self.sizes = [0] + [len(gk) for gk in groups]
        self.cumsizes = np.cumsum(self.sizes)
        self.L = int(self.cumsizes[-1])

        # overlap the IPM program's per-process trace+lower (~1.3 s at
        # large L, the dominant cold-allocation cost) with the psi /
        # invcovs host assembly below: the program shape is fully
        # determined by (L, No, N) already (solvers/sdp.py prewarm doc).
        # Gated on L >= 256: below that the trace is fast, the dummy's
        # compile+run can exceed it, and the thread would race the
        # immediately-following real solve for nothing (the 120-instance
        # small corpus would pay an extra trace per shape).
        from ..solvers.sdp import prewarm_mlblue
        from ..config import allocation_device_scope
        import threading

        # forms: (budget_epigraph, n_caps) per cone program the upcoming
        # solve will trace (prewarm_forms_for); default is the direct-eps
        # program every sdp_solve path starts from
        forms = [(False, 0)] if prewarm_forms is None \
            else [(bool(be), int(nc)) for be, nc in prewarm_forms]

        def _prewarm(L=self.L, No=self.n_outputs, n=self.N + 1,
                     forms=tuple(forms)):
            # default_device is thread-local: re-enter the allocation
            # scope or the dummy would compile for the main accelerator
            with allocation_device_scope():
                for be, nc in forms:
                    prewarm_mlblue(L, No, n, budget_epigraph=be, n_caps=nc)
                try:
                    # the solve's OTHER per-process programs: cleanup-walk
                    # matrices (one shape per output) and the corner
                    # search's batched-eigh chunks -- profiled at ~1.7s of
                    # the first allocation when cold (trace + cache load)
                    from ..solvers.integer import _chunk_var00, _CHUNK
                    eye = np.eye(self.N)
                    for b in (32, _CHUNK):
                        _chunk_var00(np.broadcast_to(
                            eye, (b, self.N, self.N)).copy())
                    for sap in self.SAPS:
                        sap.get_cleanup_matrix(np.ones(sap.L))
                except Exception:      # pragma: no cover - best effort
                    pass

        self.SAPS = [SAP(self.C[n], self.Ks[n], multi_groups[n],
                         multi_costs[n], verbose=verbose)
                     for n in range(self.n_outputs)]

        import os as _os
        if (self.L >= 256 and forms
                and _os.environ.get("BLUEST_TPU_IPM_PREWARM", "1") != "0"):
            threading.Thread(target=_prewarm, daemon=True).start()

        ES = np.zeros((self.N, self.L))
        for gidx, g in enumerate(self.flattened_groups):
            ES[np.asarray(g, dtype=int), gidx] = 1.0
        self.ES = [ES[i] for i in range(self.N)]
        self.e = self.ES[0]

        # mappings[n]: global group index of output n's local group j
        # (reference mosap.py:54-67)
        lookup = {}
        for k, gk in enumerate(groups):
            for j, g in enumerate(gk):
                lookup[tuple(g)] = int(self.cumsizes[k] + j)
        mappings = []
        for n in range(self.n_outputs):
            local = [tuple(g) for gk in multi_groups[n] for g in gk]
            mappings.append(np.array([lookup[g] for g in local],
                                     dtype=np.int64))
        self.mappings = mappings

        self.samples = None
        self.budget = None
        self.eps = None
        self.tot_cost = None
        self.n_nlp_fallbacks = 0   # times the SDP failed over to scipy
        self.certificates = []     # per-cone-solve IPM certificates
        self.continuous_solution = None

    # ------------------------------------------------------------------ #

    def check_input(self, budget, eps):
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if eps is not None:
            eps = np.atleast_1d(np.asarray(eps, dtype=float))
            if eps.shape == (1,):
                eps = np.repeat(eps, self.n_outputs)
            if eps.shape != (self.n_outputs,):
                raise ValueError("eps must be a scalar or one value per output")
        return budget, eps

    def variances(self, m, delta: float = 0.0):
        return [self.SAPS[n].variance(m[self.mappings[n]], delta=delta)
                for n in range(self.n_outputs)]

    def variance_GH(self, m, nohess: bool = False, delta: float = 0.0):
        out = [self.SAPS[n].variance_GH(m[self.mappings[n]], delta=delta,
                                        nohess=nohess)
               for n in range(self.n_outputs)]
        return ([o[0] for o in out], [o[1] for o in out], [o[2] for o in out])

    def kkt_certificate(self, m=None, eps=None):
        """Independent first-order KKT report for a continuous allocation
        (defaults to the last ``solve``'s pre-rounding point).  Verifies
        the IPM's "optimal" claim through the variance/gradient closures
        only -- the role the reference's cross-vendor ``solver_test``
        blocks play (bluest_NS.py:124-140)."""
        if m is None:
            m = self.continuous_solution
        if m is None:
            raise ValueError("no continuous solution available; solve first")
        m = np.asarray(m, dtype=float)
        if eps is None:
            eps = getattr(self, "_continuous_eps", None)

        def make_grad(n):
            def g(x):
                gl = np.zeros(self.L)
                gl[self.mappings[n]] = self.SAPS[n].variance_GH(
                    x[self.mappings[n]], nohess=True)[1]
                return gl
            return g

        grads = [make_grad(n) for n in range(self.n_outputs)]
        return certmod.kkt_certificate(m, self.costs, grads,
                                       self.variances(m), eps=eps)

    @on_allocation_device
    def get_cleanup_matrices(self, m, delta: float = 0.0) -> np.ndarray:
        # dispatch every output's kernel first, then ONE gather: the
        # cleanup walk calls this per iteration, and per-output blocking
        # fetches serialize device round trips
        # (same pattern as the corner search / _pipelined_sumse)
        import jax
        import jax.numpy as jnp
        from ..core import psi as psimod
        pending = [psimod.cleanup_matrix(
            self.SAPS[n].data,
            jnp.asarray(np.asarray(m[self.mappings[n]], dtype=float)), delta)
            for n in range(self.n_outputs)]
        Xs = []
        for n, Xn in enumerate(jax.device_get(pending)):
            X = np.zeros((self.N, self.L))
            X[:, self.mappings[n]] = Xn
            Xs.append(X)
        return np.vstack(Xs)

    def get_max_sample_constraints(self, max_model_samples):
        if max_model_samples is None:
            return [], []
        max_model_samples = np.asarray(max_model_samples)
        if max_model_samples.shape != (self.N,):
            raise ValueError("max_model_samples must have one entry per model")
        if max_model_samples[0] < 1:
            raise ValueError("The high-fidelity model must be sampled at least once.")
        es, rhs = [], []
        for i in range(self.N):
            if np.isfinite(max_model_samples[i]):
                es.append(self.ES[i])
                rhs.append(int(round(max_model_samples[i])))
        return es, rhs

    def _e_rows(self):
        rows = []
        for n in range(self.n_outputs):
            ee = np.zeros(self.L)
            ee[self.mappings[n]] = self.e[self.mappings[n]]
            rows.append(ee)
        return rows

    # ------------------------------ solve ----------------------------- #

    @on_allocation_device
    def solve(self, budget=None, eps=None, solver: str = "sdp", x0=None,
              continuous_relaxation: bool = False, max_model_samples=None,
              solver_params: Optional[dict] = None):
        budget, eps = self.check_input(budget, eps)
        self.certificates = []

        # Budget-mode solutions form a ray: V is homogeneous of degree -1
        # in m, so the continuous optimum scales linearly with the budget.
        # Solve once per (solver, no-caps) and rescale -- budget sweeps
        # (bench calibration, complexity studies) then pay only the integer
        # projection.  Per-model caps break the scaling.
        ray_key = ("budget_ray", solver)
        cached_ray = (getattr(self, "_ray_cache", {}).get(ray_key)
                      if budget is not None and max_model_samples is None
                      else None)
        # a ray is only valid at this budget while the >=1-sample rows stay
        # satisfied after rescaling (they are the one inhomogeneous part)
        if cached_ray is not None and any(
                float(ee @ cached_ray) * budget < 1.0 - 1e-9
                for ee in self._e_rows()):
            cached_ray = None
        if cached_ray is not None:
            samples = cached_ray * budget
            # the cached ray's certificates still certify this solve
            # (the continuous optimum scales linearly with the budget)
            self.certificates = list(
                getattr(self, "_ray_certs", {}).get(ray_key, []))
        elif solver in ("cvxopt", "cvxpy", "sdp"):
            samples = self.sdp_solve(budget=budget, eps=eps,
                                     max_model_samples=max_model_samples,
                                     solver_params=solver_params)
        elif solver in ("admm", "scs"):
            samples = self.sdp_solve(budget=budget, eps=eps,
                                     max_model_samples=max_model_samples,
                                     solver_params=solver_params,
                                     backend="admm")
        elif solver in ("scipy", "ipopt"):
            samples = self.scipy_solve(budget=budget, eps=eps, x0=x0,
                                       max_model_samples=max_model_samples)
        elif solver == "spg":
            samples = self.spg_solve(budget=budget, eps=eps,
                                     max_model_samples=max_model_samples)
        else:
            raise ValueError("solvers available: 'sdp' (default), "
                             "'admm', 'scipy', 'spg'")

        used_fallback = False
        if samples is None and solver in ("cvxopt", "cvxpy", "sdp",
                                          "admm", "scs"):
            # robustness fallback: the host NLP solves instances the IPM
            # stalls on (and vice versa)
            used_fallback = True
            self.n_nlp_fallbacks += 1
            if self.verbose:
                print("SDP solver failed; falling back to scipy NLP...")
            if x0 is None and getattr(self, "_sdp_guess", None) is not None \
                    and budget is not None:
                g = np.maximum(self._sdp_guess, 0)
                cost_g = float(self.costs @ g)
                if cost_g > 0 and np.all(np.isfinite(g)):
                    # interiorized blend (see the eps-mode warm start)
                    g = (0.9 * g * (budget / cost_g)
                         + 0.1 * budget / (self.L * self.costs))
                    x0 = np.concatenate(
                        [[1.05 * max(self.variances(g))], g])
            samples = self.scipy_solve(budget=budget, eps=eps, x0=x0,
                                       max_model_samples=max_model_samples)

        if samples is None:
            self.samples = None
            return None

        self.continuous_solution = np.asarray(samples, dtype=float).copy()
        self._continuous_eps = eps   # kkt_certificate's default tolerance
        # (self.eps is only set on full success, so it can go stale when
        # the integer projection fails after a good continuous solve)

        # opt-in Newton polish (solver_params={"polish": True}): drive
        # the continuous eps-mode point to ~machine-precision KKT through
        # the variance closures (allocation/polish.py), with the
        # coverage rows and any per-model caps in the KKT system.
        # Opt-in because the golden pins record raw-solver
        # numbers; eps-form only.  Per-model caps join the KKT system as
        # linear rows (round 5; the capped Matern study's 1e-8 pin).
        if (eps is not None
                and solver_params and solver_params.get("polish")):
            from .polish import polish_eps
            es_p, rhs_p = self.get_max_sample_constraints(
                max_model_samples)
            try:
                r = polish_eps(self, samples, eps, es=es_p or None,
                               rhs=rhs_p or None)
            except (FloatingPointError, ValueError):
                r = None
            eps_vec = np.broadcast_to(
                np.atleast_1d(np.asarray(eps, float)),
                (len(self.mappings),)) if r is not None else None
            if (r is not None and r["feasibility"] <= 1e-9
                    # belt-and-suspenders: every output's variance must
                    # be feasible, not just the polish's active set
                    # (advisor finding, round 4) -- and under caps,
                    # every cap row must hold
                    and np.all(np.asarray(r["variances"])
                               <= (1 + 1e-9) * eps_vec ** 2)
                    and caps_satisfied(r["m"], es_p, rhs_p)
                    and r["cost"] <= float(
                        np.asarray(samples, float) @ self.costs)
                    * (1 + 1e-12)):
                samples = r["m"]
                self.continuous_solution = samples.copy()
                self.polish_report = {
                    k: r[k] for k in ("cost", "stationarity",
                                      "feasibility", "complementarity",
                                      "newton_iters", "converged")}

        # Complete group sets make the continuous optimum massively
        # degenerate and interior-point solvers return a diffuse point of
        # the optimal face; walk it to a sparse vertex first (the
        # reference reserves this for integer-projection failures,
        # mosap.py:233-236, but a sparse allocation is strictly better
        # here: fewer active groups to sample and to compile for).
        if (not continuous_relaxation
                and np.sum(samples > 1e-9 * samples.max()) > 4 * self.N):
            # pre-truncate the interior solution's tail: converged IPM
            # points carry thousands of ~zero entries and the null-space
            # walk only removes about one per iteration
            samples = self.cleanup_solution(
                np.asarray(samples, float).copy(),
                tol=1e-7 * float(np.max(samples)))
            if eps is not None:
                # the walk tolerates a 1e-4 relative variance increase --
                # enough to push the point past the integer search's
                # 1.0001*eps^2 slack; one homogeneity rescale restores
                # max_n V_n = eps_n^2 exactly (and costs one variance eval)
                resc = self._feasibility_rescale(samples, eps)
                if resc is not None:
                    samples = resc

        if budget is not None and max_model_samples is None and all(
                # only a solution with the >=1-sample rows strictly slack
                # lies on the homogeneous ray; an active row (the epigraph
                # fall-through regime) makes the optimum budget-dependent
                float(ee @ np.asarray(samples, float)) > 1.01
                for ee in self._e_rows()):
            if not hasattr(self, "_ray_cache"):
                self._ray_cache = {}
            if not hasattr(self, "_ray_certs"):
                self._ray_certs = {}
            if continuous_relaxation or used_fallback:
                # don't displace a cleaned (sparse) ray with a diffuse one,
                # nor a cone-family ray (with its certificates) with an
                # NLP-fallback point from a transient solver failure
                self._ray_cache.setdefault(
                    ray_key, np.asarray(samples, float) / budget)
                self._ray_certs.setdefault(ray_key, list(self.certificates))
            else:
                # full solves store the post-cleanup ray: a diffuse interior
                # point cached by a continuous-relaxation sweep would make
                # every later budget-mode solve repeat the null-space
                # cleanup walk (~0.2 s at L=385) on the rescaled dense point
                self._ray_cache[ray_key] = np.asarray(samples, float) / budget
                self._ray_certs[ray_key] = list(self.certificates)

        if not continuous_relaxation:
            try:
                samples = self.integer_projection(
                    samples, budget=budget, eps=eps,
                    max_model_samples=max_model_samples)
            except AssertionError as exc:
                if self.verbose:
                    print(str(exc))
                self.samples = None
                return None

        self.samples = samples
        self.budget = budget
        self.eps = eps
        self.tot_cost = samples @ self.costs
        for n in range(self.n_outputs):
            self.SAPS[n].samples = samples[self.mappings[n]]
        return samples

    def sdp_solve(self, budget=None, eps=None, max_model_samples=None,
                  solver_params=None, backend="ipm"):
        es, rhs = self.get_max_sample_constraints(max_model_samples)
        cone_solve, params, allowed = cone_backend(backend)
        if solver_params:
            params.update({k: v for k, v in solver_params.items()
                           if k in allowed})
        psis = [s.psi for s in self.SAPS]
        e_rows = self._e_rows()

        if budget is not None:
            m_ray = None  # budget-scaled ray point (feasibility fallback)
            if len(es) == 0:
                # Budget mode without caps through the DIRECT eps form +
                # ray rescale: min-max-variance and min-cost-at-tolerance
                # are the same Pareto frontier (variance homogeneous of
                # degree -1), and the direct eps SDP conditions far better
                # than the t-epigraph on degenerate complete-group sets.
                e_common = max(np.sqrt(CC[0, 0]) for CC in self.C) / 100.0
                m = self._direct_eps_solve(
                    np.full(self.n_outputs, e_common), e_rows, [], [],
                    psis, params, rescale=False, cone_solve=cone_solve)
                # homogeneity needs the >=1-sample rows slack at the SOLVE
                # scale: if one binds (e.m near 1), the scaled ray inherits
                # its distortion -- re-solve at the tolerance that puts the
                # optimizer well inside that halfspace (e.m ~ 20)
                if m is not None:
                    lhs = min(float(ee @ m) for ee in e_rows)
                    if lhs < 10.0:
                        m2 = self._direct_eps_solve(
                            np.full(self.n_outputs,
                                    e_common * np.sqrt(max(lhs, 1.0) / 20.0)),
                            e_rows, [], [], psis, params, rescale=False,
                            cone_solve=cone_solve)
                        if m2 is not None:
                            m = m2
                if m is not None and float(m @ self.costs) > 0:
                    m_ray = m * (budget / float(m @ self.costs))
                    # at the budget scale the >=1 rows must still hold;
                    # if not, the optimum has them active (inhomogeneous
                    # regime) -- fall through to the epigraph + bisection
                    if min(float(ee @ m_ray) for ee in e_rows) >= 1.0 - 1e-9:
                        return m_ray
            c, Gl, hl, As, Hs, _ = cones.build_budget_sdp(
                psis, self.mappings, self.L, self.costs, e_rows,
                budget, es, rhs)
            res = cone_solve(c, Gl, hl, As, Hs,
                             verbose=self.verbose, **params)
            certmod.record(self.certificates, "budget-epigraph", res)
            m_epi = None
            if res.status in _OK_STATUSES:
                m_epi = np.maximum(res.x[1:], 0) * budget
                # an "inaccurate" epigraph point can overspend / overcap by
                # orders of magnitude (which also fakes a low variance in
                # the min() race below) -- treat infeasible ones as failed
                if not self._budget_feasible(m_epi, budget, es, rhs):
                    m_epi = None
            epi_tight = (m_epi is not None and certmod.is_tight(
                self.certificates[-1]))
            if epi_tight:
                return m_epi
            # Conditioning rescue: the t-epigraph LMI stalls the IPM on
            # near-degenerate covariances (the same weakness the no-caps
            # path above dodges), so solve the budget problem through the
            # well-conditioned direct-eps form with caps instead -- a
            # bisection on the common variance level v, using
            # cost(v) monotone nonincreasing (min max_n V_n at budget B
            # == smallest v whose min-cost at tolerance sqrt(v) is <= B).
            # v0 hint: the ray fall-through point, if there was one (the
            # no-caps starting probe would just repeat its solve).
            v_hint = self._max_variance(m_ray) if m_ray is not None else None
            m_bis = self._budget_caps_bisection(
                budget, e_rows, es, rhs, psis, params, cone_solve, m_epi,
                v_hint=v_hint)
            if m_bis is not None and m_epi is not None:
                return min((m_bis, m_epi),
                           key=lambda m: self._max_variance(m))
            if m_bis is not None:
                return m_bis
            if m_epi is not None:
                return m_epi
            self._stash_guess(res, budget)
            return None

        candidates = []

        # (a) direct eps SDP with the reference's meps rescale
        # (mosap.py:430-434): well conditioned when the eps_n are
        # heterogeneous (the epigraph form's LMI corners then span
        # orders of magnitude and stall the IPM)
        m = self._direct_eps_solve(eps, e_rows, es, rhs, psis, params,
                                   rescale=(len(es) == 0),
                                   cone_solve=cone_solve)
        have_a = m is not None
        if m is not None:
            candidates.append(m)

        # (b) scaled weighted min-max (budget epigraph) + exact rescale --
        # only valid without caps.  At large L an extra 3000-variable SDP
        # costs minutes; the direct form (a) is the better-conditioned one
        # on degenerate sets, so (b) is only worth running as a
        # cross-check/cost-race when (a) failed or its certificate is
        # loose (each extra cone program costs a per-process trace+lower
        # on top of the solve -- the dominant cold-allocation cost).
        a_tight = bool(self.certificates) and certmod.is_tight(
            self.certificates[-1])
        if len(es) == 0 and (not candidates
                             or (self.L <= 600 and not a_tight)):
            c, Gl, hl, As, Hs, _ = cones.build_budget_sdp(
                psis, self.mappings, self.L, self.costs, [], 1.0,
                eps_weights=np.asarray(eps, dtype=float))
            res = cone_solve(c, Gl, hl, As, Hs,
                             verbose=self.verbose, **params)
            certmod.record(self.certificates, "scaled-budget-epigraph", res)
            if res.status in _OK_STATUSES:
                m = self._feasibility_rescale(res.x[1:], eps)
                if m is not None:
                    candidates.append(m)
            elif not candidates:
                self._stash_guess(res, None)

        if not candidates:
            return None

        def _gross(mm):
            """Independent first-order screen: a point whose active-set
            stationarity is O(1) RELATIVE did not come from a converged
            convex solve -- it is a stalled cone program's iterate whose
            self-consistent feasibility rescale hides a garbage cost.
            Observed once on the NS K=7 golden under host stress:
            the direct form's isolation worker crashed, the epigraph
            cross-check (the form the direct one exists to dodge on
            degenerate sets) returned 'inaccurate', and its rescaled
            point undercut the true optimum by 38% while passing every
            self-consistent check.  The 0.3 threshold sits orders above
            any accepted point's stationarity (~1e-3 on loose-certificate
            solves) and orders below a stalled iterate's O(1)."""
            try:
                cert = self.kkt_certificate(np.asarray(mm, float),
                                            eps=np.asarray(eps, float))
            except Exception:
                return True
            s = cert.get("stationarity", np.inf)
            return not (np.isfinite(s) and s <= 0.3)

        win = min(candidates, key=lambda m: float(m @ self.costs))
        if len(candidates) == 2 and win is candidates[1]:
            # the epigraph cross-check undercutting the direct form by
            # >10% on a CONVEX program means one of them is garbage --
            # screen the winner, keep the direct point if it is
            if (float(win @ self.costs)
                    < 0.9 * float(candidates[0] @ self.costs)
                    and _gross(win)):
                return candidates[0]
            return win
        if not have_a and _gross(win):
            # epigraph-only path (the direct solve failed outright, e.g.
            # an isolation-worker infra crash): a gross point here must
            # fail over to the NLP chain, not masquerade as an optimum
            return None
        return win

    def _feasibility_rescale(self, m0, eps):
        """m -> alpha*m with alpha = max_n V_n(m)/eps_n^2: the variance is
        homogeneous of degree -1 in m, so this lands exactly on the binding
        tolerance (shrinking cost when the solver overshoots)."""
        m0 = np.maximum(m0, 0)
        if m0.max() <= 0:
            return None
        Ksc = 1.0 / m0.max()  # V(m0) = Ksc * V(Ksc m0), dodges the
        try:                  # 0.05-entry cutoff in variance()
            alpha = max(
                Ksc * self.SAPS[n].variance(Ksc * m0[self.mappings[n]])
                / eps[n] ** 2 for n in range(self.n_outputs))
            if not np.isfinite(alpha) or alpha <= 0:
                return None
            # On ill-conditioned PHI the evaluated variance carries
            # ~cond*1e-16 relative noise that is NOT scale-invariant, so
            # the homogeneity rescale can land ~1e-3 off tolerance;
            # one corrective evaluation at the final scale removes the bias
            m1 = alpha * m0
            corr = max(self.SAPS[n].variance(m1[self.mappings[n]])
                       / eps[n] ** 2 for n in range(self.n_outputs))
            if np.isfinite(corr) and corr > 0:
                alpha = alpha * corr
        except (AssertionError, np.linalg.LinAlgError):
            return None
        if not np.isfinite(alpha) or alpha <= 0:
            return None
        return alpha * m0

    def _max_variance(self, m):
        """max_n V_n(m) (the cutoff-dodging evaluation; inf on failure)."""
        return max(self._eps_ratio_n(m, np.ones(self.n_outputs), n)
                   for n in range(self.n_outputs))

    def _budget_feasible(self, m, budget, es, rhs):
        """Budget + cap rows hold (slack matches the NLP validators)."""
        m = np.maximum(np.asarray(m, dtype=float), 0)
        if float(m @ self.costs) > 1.0001 * budget:
            return False
        return caps_satisfied(m, es, rhs)

    def _budget_caps_bisection(self, budget, e_rows, es, rhs, psis, params,
                               cone_solve, m_epi=None, v_hint=None):
        """Budget mode under per-model caps via the direct-eps form.

        cost(v) := min {w.m : V_n(m) <= v for all n, m >= 0, caps} is
        monotone nonincreasing in the common variance level v (see
        sap.budget_level_bisection).  Every solve reuses ONE traced cone
        program (the (eps, n_caps) shape is fixed; only hl data changes),
        so the bisection costs iterations-many IPM dispatches, not
        compiles."""
        def cost_at(v):
            eps_v = np.full(self.n_outputs, np.sqrt(v))
            m = self._direct_eps_solve(eps_v, e_rows, es, rhs, psis,
                                       params, rescale=False,
                                       cone_solve=cone_solve, validate=True)
            if m is None:
                # certified infeasibility (tau collapse) marks the cap
                # floor: underspending there is the true optimum (see
                # sap.budget_level_bisection)
                return None, np.inf, (self.certificates[-1]["status"]
                                      == "infeasible")
            return m, float(m @ self.costs), False

        # starting level: the epigraph candidate's achieved level, else the
        # caller's hint (e.g. the ray fall-through point), else the no-caps
        # ray's level at this budget (a lower bound -- caps only shrink the
        # feasible set); last resort a covariance-derived default so a
        # degenerate m_epi never silently skips the rescue
        v = self._max_variance(m_epi) if m_epi is not None else np.inf
        if (not np.isfinite(v) or v <= 0) and v_hint is not None:
            v = v_hint
        if not np.isfinite(v) or v <= 0:
            e_common = max(np.sqrt(CC[0, 0]) for CC in self.C) / 100.0
            m0 = self._direct_eps_solve(
                np.full(self.n_outputs, e_common), e_rows, [], [],
                psis, params, rescale=False, cone_solve=cone_solve)
            if m0 is not None and float(m0 @ self.costs) > 0:
                v = self._max_variance(m0 * (budget / float(m0 @ self.costs)))
        if not np.isfinite(v) or v <= 0:
            v = max(CC[0, 0] for CC in self.C) / 1e4
        return budget_level_bisection(cost_at, v, budget)

    def _direct_eps_solve(self, eps, e_rows, es, rhs, psis, params,
                          rescale: bool = True, cone_solve=solve_cone_lp,
                          validate=None):
        """Direct eps-form SDP with the meps conditioning rescale.

        ``validate``: tolerance-check the point (V_n <= 1.05 eps_n^2)
        instead of trusting solver status -- for the first-order backend
        on near-degenerate instances an "optimal"/"inaccurate" point can
        be tolerance-infeasible by orders of magnitude, so rejection here
        engages the caller's fallback chain.  Defaults to on whenever
        the homogeneity rescale is unavailable to fix feasibility (caps
        present); the budget bisection forces it on (its monotone
        cost(v) assumption needs tolerance-true points), and the budget
        ray forces it off (only the point's direction matters there)."""
        n_mc = max(CC[0, 0] / ep ** 2 for CC, ep in zip(self.C, eps))
        meps = 100.0 / np.sqrt(n_mc)
        c, Gl, hl, As, Hs, _ = cones.build_eps_sdp(
            psis, self.mappings, self.L, self.costs, e_rows,
            np.asarray(eps) / meps, meps, es, rhs)
        res = cone_solve(c, Gl, hl, As, Hs, verbose=self.verbose,
                         **params)
        certmod.record(self.certificates, "direct-eps", res)
        if res.status not in _OK_STATUSES:
            return None
        m = np.maximum(res.x, 0) / meps ** 2
        if rescale:
            m = self._feasibility_rescale(m, eps)
        elif (len(es) > 0 if validate is None else validate):
            ratio = max(self._eps_ratio_n(m, eps, n)
                        for n in range(self.n_outputs))
            if not np.isfinite(ratio) or ratio > 1.05:
                return None
            # an "inaccurate" point can also overcap -- oversampling a
            # capped model FAKES a low variance, so the tolerance check
            # alone would bless exactly the bad points
            if not caps_satisfied(m, es, rhs):
                return None
        return m

    def _eps_ratio_n(self, m, eps, n):
        """V_n(m)/eps_n^2 via the cutoff-dodging scale trick."""
        m = np.maximum(np.asarray(m, dtype=float), 0)
        if m.max() <= 0:
            return np.inf
        Ksc = 1.0 / m.max()
        try:
            r = (Ksc * self.SAPS[n].variance(Ksc * m[self.mappings[n]])
                 / eps[n] ** 2)
        except (AssertionError, np.linalg.LinAlgError):
            return np.inf
        # NaN would poison every downstream min()/max() race key
        return r if np.isfinite(r) else np.inf

    def _stash_guess(self, res, budget):
        """Keep a failed IPM's best iterate as a warm start for the NLP
        fallback (feasibility is typically at machine precision even when
        the duality gap stalls)."""
        self._sdp_guess = None
        x = np.asarray(res.x)
        if x.shape[0] == self.L + 1 and np.all(np.isfinite(x)):
            m = np.maximum(x[1:], 0)
            if budget is not None:
                m = m * budget
            self._sdp_guess = m

    @on_allocation_device
    def spg_solve(self, budget=None, eps=None, max_model_samples=None):
        """Third continuous solver family (projected spectral gradient on
        the smoothed max-variance, solvers/spg_alloc.py) for
        cross-validation; eps mode by homogeneity, or budget bisection
        when per-model caps break the homogeneity reduction."""
        from ..solvers.spg_alloc import (_cap_arrays,
                                         solve_budget_spg_multi,
                                         eps_caps_budget_search)
        datas = [s.data for s in self.SAPS]
        es, rhs = self.get_max_sample_constraints(max_model_samples)
        cr, crhs = _cap_arrays(self.L, es, rhs)
        if budget is None:
            # homogeneity reduction with per-output weights eps_n^2:
            # min max_n V_n/eps_n^2 at a fixed budget + exact rescale is
            # the min-cost point at the heterogeneous tolerances
            m0 = solve_budget_spg_multi(
                datas, self.mappings, self.L, self.costs,
                10.0 * float(self.costs.sum()),
                weights=np.asarray(eps, dtype=float) ** 2)
            if m0 is None:
                return None
            m0 = self._feasibility_rescale(m0, eps)
            if m0 is None:
                return None
            if np.all(cr @ m0 <= crhs + 1e-9):   # vacuous when no caps
                return m0

            def ratio_of(m):
                m = np.maximum(m, 0)
                Ksc = 1.0 / max(m.max(), 1e-300)
                try:
                    r = max(Ksc * self.SAPS[n].variance(
                        Ksc * m[self.mappings[n]]) / eps[n] ** 2
                        for n in range(self.n_outputs))
                except (AssertionError, np.linalg.LinAlgError):
                    return np.inf
                return r if np.isfinite(r) and r > 0 else np.inf

            wts = np.asarray(eps, dtype=float) ** 2
            return eps_caps_budget_search(
                lambda B, x0: solve_budget_spg_multi(
                    datas, self.mappings, self.L, self.costs, B,
                    weights=wts, cap_rows=cr, cap_rhs=crhs, x0=x0),
                ratio_of, float(self.costs @ m0))
        return solve_budget_spg_multi(datas, self.mappings, self.L,
                                      self.costs, float(budget),
                                      cap_rows=cr, cap_rhs=crhs)

    # --- reference method-name aliases (mosap.py:395, 500, 615).  Like
    # the reference they normalize eps via check_input (scalar accepted)
    # and start a fresh certificate list (solve() is not on this path).
    # Each records its result as the current continuous solution so a
    # subsequent kkt_certificate() verifies THIS point, not a stale one
    # from an earlier solve().
    def _record_continuous(self, samples, eps):
        if samples is not None:
            self.continuous_solution = np.asarray(samples, float).copy()
            self._continuous_eps = eps
        return samples

    def cvxopt_solve(self, budget=None, eps=None, delta=0.0,
                     max_model_samples=None, cvxopt_params=None):
        budget, eps = self.check_input(budget, eps)
        self.certificates = []
        return self._record_continuous(
            self.sdp_solve(budget=budget, eps=eps,
                           max_model_samples=max_model_samples,
                           solver_params=cvxopt_params), eps)

    def cvxpy_solve(self, budget=None, eps=None, delta=0.0,
                    max_model_samples=None, cvxpy_params=None):
        budget, eps = self.check_input(budget, eps)
        self.certificates = []
        return self._record_continuous(
            self.sdp_solve(budget=budget, eps=eps,
                           max_model_samples=max_model_samples,
                           solver_params=cvxpy_params), eps)

    def ipopt_solve(self, budget=None, eps=None, x0=None,
                    max_model_samples=None):
        budget, eps = self.check_input(budget, eps)
        return self._record_continuous(
            self.scipy_solve(budget=budget, eps=eps, x0=x0,
                             max_model_samples=max_model_samples), eps)

    def scipy_solve(self, budget=None, eps=None, x0=None,
                    max_model_samples=None, eps_weights=None):
        """Epigraph NLP (reference mosap.py:562-613).

        eps mode without sample caps is solved through the scaled weighted
        budget problem (same homogeneity identity as sdp_solve): the direct
        eps-mode NLP is badly scaled (m ~ V/eps^2 >> 1) and trust-constr
        routinely returns grossly oversampled feasible points from it.
        """
        from scipy.optimize import minimize, LinearConstraint, \
            NonlinearConstraint, Bounds

        L = self.L
        No = self.n_outputs
        w = self.costs
        delta = 1.0e-15
        es, rhs = self.get_max_sample_constraints(max_model_samples)
        e_rows = self._e_rows()

        if budget is None and eps is not None and len(es) == 0:
            # budget value is arbitrary by homogeneity; pick one that puts
            # the allocation entries at O(1) for the NLP
            B = 10.0 * float(w.sum())
            if x0 is None and getattr(self, "_sdp_guess", None) is not None:
                g = np.maximum(self._sdp_guess, 0)
                cost_g = float(w @ g)
                if cost_g > 0 and np.all(np.isfinite(g)):
                    # interiorize: blend 10% of a uniform cost share so the
                    # warm start does not hug the m >= 0 boundary (where
                    # trust-constr's keep_feasible bounds strangle steps)
                    g = 0.9 * g * (B / cost_g) + 0.1 * B / (self.L * w)
                    x0 = np.concatenate([
                        [1.05 * max(v / e ** 2 for v, e in zip(
                            self.variances(g), eps))], g])
            m0 = self.scipy_solve(budget=B, x0=x0, eps_weights=eps)
            if m0 is None:
                return None
            # homogeneity rescale WITH the corrective final-scale
            # evaluation (_feasibility_rescale).  The bare K-trick alpha
            # used here before is evaluated at the normalized scale, and
            # on ill-conditioned PHI the variance evaluation's noise is
            # NOT scale-invariant -- on the NS K=7 golden the bias was a
            # factor ~1.8, i.e. this path returned a point that was 81%
            # ABOVE tolerance (and 38% "cheaper" than the optimum) while
            # every self-consistent check passed.
            m1 = self._feasibility_rescale(np.maximum(m0, 0), eps)
            if m1 is None:
                return None
            # iterate the DIRECT final-scale evaluation to tolerance;
            # reject honestly if it will not settle (the caller's NLP
            # chain then reports failure instead of silent infeasibility)
            ratio = np.inf
            for _ in range(4):
                try:
                    ratio = max(self.SAPS[n].variance(m1[self.mappings[n]])
                                / eps[n] ** 2 for n in range(No))
                except (AssertionError, np.linalg.LinAlgError):
                    return None
                if not (np.isfinite(ratio) and ratio > 0):
                    return None
                if ratio <= 1.0001:
                    break
                m1 = ratio * m1
            if not ratio <= 1.05:
                return None
            return m1

        if eps_weights is None:
            eps_weights = np.ones(No)

        if budget is not None:
            bounds = Bounds(np.zeros(L + 1), np.inf * np.ones(L + 1),
                            keep_feasible=True)
            cons = [LinearConstraint(np.concatenate([[0], w]), -np.inf, budget)]
            cons += [LinearConstraint(np.concatenate([[0], ee]), 1, np.inf,
                                      keep_feasible=True) for ee in e_rows]
            cons += [LinearConstraint(np.concatenate([[0], ees]), -np.inf, rr)
                     for ees, rr in zip(es, rhs)]

            def make_epi(nn):
                mp = self.mappings[nn]
                sap = self.SAPS[nn]

                ww = float(eps_weights[nn]) ** 2

                def f(x):
                    return x[0] - sap.variance(x[1:][mp], delta=delta) / ww

                def jac(x):
                    g = np.zeros(L + 1); g[0] = 1.0
                    gv = sap.variance_GH(x[1:][mp], nohess=True, delta=delta)[1]
                    g[1 + mp] = -gv / ww
                    return g

                def hess(x, v):
                    Hn = sap.variance_GH(x[1:][mp], delta=delta)[2]
                    out = np.zeros((L + 1, L + 1))
                    out[np.ix_(1 + mp, 1 + mp)] = -Hn / ww
                    return float(np.atleast_1d(v)[0]) * out

                return NonlinearConstraint(f, 0, np.inf, jac=jac, hess=hess)

            cons += [make_epi(n) for n in range(No)]
            if x0 is None:
                m0 = np.full(L, budget / w.sum())
                x0 = np.concatenate([[max(self.variances(m0, delta=delta))], m0])
            eee = np.zeros(L + 1); eee[0] = 1.0
            r = minimize(lambda x: (x[0], eee), x0, jac=True,
                         hessp=lambda x, p: np.zeros(L + 1), bounds=bounds,
                         constraints=cons, method="trust-constr",
                         options={"maxiter": 5000,
                                  "verbose": 3 * int(self.verbose)},
                         tol=1e-7)
            def budget_feasible(x):
                m = np.maximum(x[1:], 0)
                if w @ m > 1.0001 * budget:
                    return False
                return caps_satisfied(m, es, rhs)
            x = validated_nlp_point(r, budget_feasible)
            return None if x is None else x[1:]

        bounds = Bounds(np.zeros(L), np.inf * np.ones(L), keep_feasible=True)
        cons = [LinearConstraint(ee, 1, np.inf, keep_feasible=True)
                for ee in e_rows]
        cons += [LinearConstraint(ees, -np.inf, rr) for ees, rr in zip(es, rhs)]

        def make_var(nn):
            mp = self.mappings[nn]
            sap = self.SAPS[nn]

            def f(x):
                return sap.variance(x[mp], delta=delta)

            def jac(x):
                g = np.zeros(L)
                g[mp] = sap.variance_GH(x[mp], nohess=True, delta=delta)[1]
                return g

            return NonlinearConstraint(f, -np.inf, eps[nn] ** 2, jac=jac)

        cons += [make_var(n) for n in range(No)]
        if x0 is None:
            x0 = np.ceil(np.linalg.norm(eps) ** -2 * np.ones(L))
        wn = w / np.linalg.norm(w)
        r = minimize(lambda x: (wn @ x, wn), x0, jac=True,
                     hessp=lambda x, p: np.zeros(L), bounds=bounds,
                     constraints=cons, method="trust-constr",
                     options={"maxiter": 5000,
                              "verbose": 3 * int(self.verbose)}, tol=1e-7)

        def feasible(x):
            m = np.maximum(x, 0)
            # the caps are constraints too: without this check a stalled
            # trust-constr can return a massively oversampled point that
            # is variance-feasible but violates the caps by orders of
            # magnitude (seen on the Matern golden's degenerate instance)
            if not caps_satisfied(m, es, rhs):
                return False
            try:
                return all(
                    self.SAPS[n].variance(m[self.mappings[n]], delta=delta)
                    <= 1.001 * eps[n] ** 2 for n in range(No))
            except (AssertionError, np.linalg.LinAlgError):
                return False
        return validated_nlp_point(r, feasible)

    # ------------------------ cleanup sparsifier ----------------------- #

    @on_allocation_device
    def cleanup_solution(self, m, delta: float = 0.0, tol: float = 0.0):
        """Null-space walk reducing the number of active groups without
        worsening the max variance (reference mosap.py:125-210)."""
        from scipy.linalg import null_space

        m = np.asarray(m, dtype=float).copy()
        N, L, w, No = self.N, self.L, self.costs, self.n_outputs
        E = np.vstack(self._e_rows())

        idx = np.where(m > tol)[0]
        V0 = max(self.variances(m, delta=delta))
        V = V0
        it = 0
        nullsize = -1
        if self.verbose:
            print("Solution cleanup started: nnz=%d, variance=%e" % (len(idx), V))
        while len(idx) > N:
            idx = np.where(m > tol)[0]
            m[m < tol] = 0
            wr = w[idx]
            Er = E[:, idx]
            it += 1

            X = self.get_cleanup_matrices(m, delta=delta)[:, idx]
            NN = null_space(X)
            vals = wr @ NN
            signs = np.sign(vals)
            NN[:, signs > 0] *= -1
            vals[signs > 0] *= -1
            NN = NN[:, np.abs(signs) > 0]
            vals = vals[np.abs(signs) > 0]
            order = np.argsort(np.abs(vals))[::-1]
            nullsize = len(vals)
            if nullsize == 0:
                break
            em = Er @ m[idx]

            smax = 0.0
            for j in range(nullsize):
                t = NN[:, order[j]]
                evals = Er @ t
                neg = np.where(evals < 0)[0]
                smax1 = np.inf if len(neg) == 0 else \
                    np.min(np.abs(em[neg] - 1) / np.abs(evals[neg]))
                neg = np.where(t < 0)[0]
                smax2 = np.inf if len(neg) == 0 else \
                    np.min(m[idx][neg] / np.abs(t[neg]))
                smax = max(min(smax1, smax2), 0.0)
                if smax > 5 * tol:
                    tt = np.zeros_like(m)
                    tt[idx] = t
                    mnew = m + smax * tt
                    Vn = max(self.variances(mnew, delta=delta))
                    if Vn < V0 or abs(Vn - V0) / abs(V0) < 1.0e-4:
                        m = mnew
                        V = Vn
                        break
                    smax = 0.0
            if smax <= 5 * tol:
                break

        m[m < tol] = 0
        if self.verbose:
            print("Solution cleanup done: nnz=%d, variance=%e"
                  % (int(np.sum(m > tol)), max(self.variances(m, delta=delta))))
        return m

    # ------------------------ integer projection ----------------------- #

    @on_allocation_device
    def integer_projection(self, samples, budget=None, eps=None,
                           max_model_samples=None):
        """(reference mosap.py:212-289)"""
        if budget is None and eps is None:
            raise ValueError("Need to specify either budget or RMSE tolerance")
        if self.verbose:
            print("Integer projection...")

        ss = np.asarray(samples, dtype=float).copy()
        ES, rhs = self.get_max_sample_constraints(max_model_samples)
        psis = [s.psi for s in self.SAPS]

        out, fval = best_integer_blue_multi(
            ss, psis, self.costs, self.e, self.mappings,
            budget=budget, eps=eps, max_samples_info=(ES, rhs))

        css = None
        if np.isinf(fval):
            if self.verbose:
                print("Integer projection failed; trying cleanup...")
            css = self.cleanup_solution(ss.copy())
            out, fval = best_integer_blue_multi(
                css, psis, self.costs, self.e, self.mappings,
                budget=budget, eps=eps, max_samples_info=(ES, rhs))

        if np.isinf(fval):
            for i in reversed(range(4)):
                fac = 10.0 ** -i
                nb = None if budget is None else budget * (1 + fac)
                ne = None if eps is None else np.sqrt(np.asarray(eps) ** 2 * (1 + fac))
                if self.verbose:
                    print("WARNING! Increasing tolerance/budget by %g." % (1 + fac))
                out, fval = best_integer_blue_multi(
                    ss, psis, self.costs, self.e, self.mappings,
                    budget=nb, eps=ne, max_samples_info=(ES, rhs))
                if np.isinf(fval):
                    out, fval = best_integer_blue_multi(
                        css, psis, self.costs, self.e, self.mappings,
                        budget=nb, eps=ne, max_samples_info=(ES, rhs))
                if not np.isinf(fval):
                    break

        if np.isinf(fval):
            out = self._round_fallback(ss, css, budget, eps, ES, rhs,
                                       max_model_samples)

        return np.asarray(out, dtype=np.int64)

    def _round_fallback(self, ss, css, budget, eps, ES, rhs,
                        max_model_samples):
        """Last-resort rounding (reference mosap.py:249-287)."""
        if css is None:
            css = ss
        ssf, ssc = np.floor(ss), np.ceil(ss)
        cssf, cssc = np.floor(css), np.ceil(css)
        var_ss = max(self.variances(ssc))
        var_css = max(self.variances(cssc))
        cost_ss = ssc @ self.costs
        cost_css = cssc @ self.costs

        if max_model_samples is not None:
            if all(ssc @ ees <= rr for ees, rr in zip(ES, rhs)):
                return ssc
            if all(cssc @ ees <= rr for ees, rr in zip(ES, rhs)):
                return cssc
            for cand in (ssf, cssf):
                if all(cand[self.mappings[n]] @ self.e[self.mappings[n]] >= 1
                       for n in range(self.n_outputs)):
                    return cand
        if eps is None:
            return ssc if cost_ss < cost_css else cssc
        return ssc if var_ss < var_css else cssc

    # ------------------------ estimator assembly ----------------------- #

    def compute_BLUE_estimators(self, sums, samples):
        """(mus, Vars) per output (reference mosap.py:113-123)."""
        samples = np.asarray(samples, dtype=float)
        mus, Vs = [], []
        for n in range(self.n_outputs):
            sums_n = [sums[n][g] for g in self.mappings[n]]
            mu, v = self.SAPS[n].compute_BLUE_estimator(
                sums_n, samples=samples[self.mappings[n]])
            mus.append(mu)
            Vs.append(v)
        return mus, np.array(Vs)
