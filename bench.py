#!/usr/bin/env python
"""bluest_tpu benchmark: the BASELINE.json north-star configuration.

Ten-model, three-output MLBLUE on the stochastic diffusion hierarchy:
all couplings up to K=4 (L = 385 groups), allocation solved by the
JAX-native interior-point SDP, then an estimation run sized to ~1e6
coupled model evaluations through the vmapped/sharded sampling engine.

vs_baseline compares against the reference's architecture class on the
same machine: a per-sample Python loop with scipy banded solves (how a
croci/bluest user would evaluate this model hierarchy, blue_fn.py:115-167)
for the sampling phase, and the scipy trust-constr NLP path for the
allocation phase (the reference's non-SDP solver, sap.py:387-418).
The baseline sampling loop is measured on a subset and extrapolated
linearly.

``value`` is the steady-state end-to-end wall: a from-scratch
allocation re-solve on warm compiled programs (alloc_rebuild_s) plus
the estimation run (sample_s).  The first allocation's wall, which also
pays whatever the persistent compile cache could not supply, is
reported as alloc_cold_s.

The bench runs on whatever device JAX gives it and never switches
platform itself.  It prints the platform, device kind and count, and
the card's name and power limit on stderr, then exactly one JSON line:
  {"metric": ..., "value": ..., "unit": "s", "vs_baseline": ...,
   "alloc_rebuild_s": ..., "alloc_warm_s": ..., "sample_s": ...,
   "evals_per_s": ..., "max_rel_err": ..., "device": ...,
   "mfu": ..., "detail": {...}}
``mfu`` divides by the device's entry in ``_DEVICE_PEAKS``; a GPU
missing from that table is an error, and a CPU run reports "not
measured".
"""

import json
import os
import sys
import time

import numpy as np


GRIDS = (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2)
N_KL = 32
SIGMA = 1.0
NU = 0.6
K = 4
TARGET_SAMPLES = 1_000_000
PILOT = 4096
BATCH = 8192
BASELINE_SAMPLE_CAP = 2000


def build_problem(verbose=False, f64=False):
    import os
    import jax.numpy as jnp
    from bluest_tpu.models.diffusion import DiffusionProblem
    # the model solves in f32 by default (estimator sums accumulate in
    # f64); f64=True gives the f64 model rep.  The batch of 8192 was
    # tuned on the previous accelerator and is not yet re-swept on the
    # H100 (ROADMAP A5).
    kw = dict(grids=GRIDS, n_kl=N_KL, sigma=SIGMA, nu=NU,
              multi_output=True, verbose=verbose,
              device_batch_size=BATCH,
              dtype=None if f64 else jnp.float32)
    # the pilot covariance phase is deterministic (fixed seed) and takes
    # minutes; it is NOT part of the timed metric (alloc + estimation),
    # so cache the estimated model graph between runs (the library's own
    # reference-format npz persistence, problem.save/load_graph_data)
    cachefile = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             ".bench_graph_%s_%d.npz" % (
                                 "x".join(str(g) for g in GRIDS), PILOT))
    if os.path.exists(cachefile):
        problem = DiffusionProblem(datafile=cachefile, **kw)
        # the skipped pilot phase is also what warms the per-model
        # sampling kernels and per-size combiners; warm them here so the
        # timed estimation phase measures sampling, not compile-cache
        # loads (matching the no-cache run, where the pilot warms them)
        M = len(GRIDS)
        for l in range(M):
            problem.blue_fn([l], 1, verbose=False)
        for k in range(2, min(M, K) + 1):
            problem.blue_fn(list(range(k)), 1, verbose=False)
        # trace+compile the allocation cone program during warm-up too
        # (library API; the no-cache run overlaps this with the pilot)
        problem.prewarm_solver(K=K)
        return problem
    problem = DiffusionProblem(covariance_estimation_samples=PILOT, **kw)
    try:
        problem.save_graph_data(cachefile)
    except Exception:
        pass
    problem.prewarm_solver(K=K)
    return problem


def total_evaluations(problem):
    out = problem.MOSAP_output
    return int(sum(int(n) * len(g) for g, n in
                   zip(out["flattened_groups"], out["samples"])))


def total_samples(problem):
    return int(np.sum(problem.MOSAP_output["samples"]))


# ---------------------- flops / roofline accounting ---------------------- #
# Published per-card peaks, keyed by JAX's ``device_kind``.  Source:
# NVIDIA H100 data sheet, SXM part, dense rates at the 700 W power limit.
# The model path is f32 elementwise work plus a small f32 contraction,
# so ``mfu`` divides by the f32 (non-tensor-core) rate; the other rates
# are kept for roofline readouts.
_DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops": 67e12, "bf16_flops": 989e12,
                              "tf32_flops": 495e12, "hbm_gb_s": 3350.0},
}
_PEAK_SOURCE = "NVIDIA H100 SXM data sheet, dense, 700 W"


def device_peaks(platform, kind):
    """Peak rates of the card, or None on the CPU backend (where a
    device rate is not measured).  A GPU missing from the table is an
    error, not a default."""
    if platform == "cpu":
        return None
    if kind not in _DEVICE_PEAKS:
        raise KeyError("no published peaks for device_kind %r; add it to "
                       "bench._DEVICE_PEAKS with its source" % kind)
    return _DEVICE_PEAKS[kind]


def flops_per_sample(l):
    """Documented flop count of ONE coupled-sample evaluation of model l
    (models/diffusion.py): n = grid cells, k = N_KL modes.

    * KL mode synthesis ``modes @ (ck*xi)``: a (n,k)@(k,) contraction per
      sample = 2nk flops (under vmap this is an (n,k)@(k,B) matmul;
      the sin() mode matrix itself is sample-independent and hoisted).
    * cyclic reduction (log2 n levels, total reduced indices ~ n):
      forward ~12 flops/index + back substitution ~5 = ~17n.
    * tridiagonal assembly + exp + three QoIs: ~11n.
    """
    n = GRIDS[l]
    return 2.0 * n * N_KL + 28.0 * n


def bytes_per_sample(l, itemsize=4):
    """Estimated HBM traffic of one sample of model l (+-2x accounting,
    for the roofline readout only) on the plain path: cyclic reduction
    streams 4 arrays through ~2n elements of levels (read) + ~n writes
    each, plus the coefficient/QoI passes ~ 8n -> ~ 21n elements.  The
    fused Triton kernel that f32 models take on a GPU
    (ops/triton_diffusion.py) writes and reads back a, cp, dp: ~6n."""
    return 21.0 * GRIDS[l] * itemsize


def sampling_flops(problem):
    """Total model-evaluation flops of the solved allocation."""
    out = problem.MOSAP_output
    fl = sum(int(n) * sum(flops_per_sample(l) for l in g)
             for g, n in zip(out["flattened_groups"], out["samples"]))
    by = sum(int(n) * sum(bytes_per_sample(l) for l in g)
             for g, n in zip(out["flattened_groups"], out["samples"]))
    return float(fl), float(by)


def nvidia_smi(*args):
    """Non-empty output lines of ``nvidia-smi args`` (a child process that
    stays off JAX), or None when the tool is absent or fails."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", *args], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return [s.strip() for s in out.stdout.splitlines() if s.strip()]


CARD_QUERY = ("--query-gpu=name,power.limit", "--format=csv,noheader")


def device_info():
    """(platform, device_kind, device count) as JAX reports them."""
    import jax
    devs = jax.devices()
    return devs[0].platform, devs[0].device_kind, len(devs)


def ipm_report(problem):
    """Flops accounting for the final cone solve (the allocation hot
    loop): dims recorded by solvers.sdp.solve_cone_lp, flop model
    documented in solvers.sdp.ipm_iteration_flops."""
    from bluest_tpu.solvers.sdp import ipm_iteration_flops
    certs = [c for c in getattr(problem.MOSAP, "certificates", [])
             if c.get("dims") and c.get("iterations", 0) > 0]
    if not certs:
        return None
    c = certs[-1]
    d = c["dims"]
    fpi = ipm_iteration_flops(d)
    wall = d.get("wall_s")
    # GF/s from the WINNING attempt's wall (excludes a conservative
    # retry's iterations; still includes trace/compile iff that attempt
    # was the process-cold one -- the headline cert comes from the warm
    # rebuild rep, where programs are compiled).  Advisor finding r4.
    wall_att = d.get("wall_attempt_s", wall)
    rep = {
        "nx": d["nx"], "nb": d["nb"], "n": d["n"], "rank": d["rank"],
        "woodbury": bool(d["woodbury"]),
        "iterations": int(c["iterations"]),
        "warm_start": bool(d.get("warm_start", False)),
        "flops_per_iter_est": round(fpi),
        "solve_wall_s": None if wall is None else round(wall, 4),
        "ms_per_iter": (None if not wall_att or not c["iterations"] else
                        round(1e3 * wall_att / c["iterations"], 2)),
        "device": "host-cpu (allocation backend, f64)",
    }
    if d.get("retried"):
        rep["retried"] = True
    if wall_att:
        rep["achieved_gflops"] = round(
            fpi * c["iterations"] / wall_att / 1e9, 2)
    return rep


def calibrate_budget(problem, budget=2.0e4, k=None, target=None):
    """Budget whose allocation draws ~``target`` coupled samples.

    The allocation ray is homogeneous in the budget, so the calibration
    only needs the CONTINUOUS totals; the integer corner search runs
    once, in the caller's final ``setup_solver``."""
    k = K if k is None else k
    target = TARGET_SAMPLES if target is None else target
    problem.setup_solver(K=k, budget=budget, continuous_relaxation=True)
    for _ in range(3):
        n0 = total_samples(problem)
        if 0.85 <= n0 / target <= 1.15:
            break
        budget = budget * target / max(n0, 1)
        problem.setup_solver(K=k, budget=budget, continuous_relaxation=True)
    return budget


def run_bluest_tpu(problem, budget0=2.0e4):
    """Returns (alloc_seconds, sample_seconds, n_evals, mus, errs)."""
    # two allocation reps: rep 1 is the headline (first allocation in a
    # prewarmed process, the round-2-comparable semantics); rep 2 drops
    # the MOSAP structure + ray caches and re-solves from scratch, so it
    # isolates the steady-state re-solve cost (structure assembly + IPM +
    # cleanup + integer search with the per-shape jit programs already
    # compiled).  The reps are NOT interchangeable -- rep 1 additionally
    # pays the per-process compiles of the solve-time-shaped programs
    # (integer corner search, certificate kernels) that prewarm cannot
    # know ahead of time -- so no min() across them.
    alloc_runs = []
    budget = budget0
    for rep in range(2):
        if rep:
            problem._mosap_key = None    # fresh MOSAP: no ray/structure cache
        t0 = time.time()
        # rescale the budget so the estimation phase draws ~TARGET_SAMPLES
        # (rep 2 starts at the calibrated budget and converges at once,
        # but still pays the same solve sequence on a fresh structure)
        budget = calibrate_budget(problem, budget)
        problem.setup_solver(K=K, budget=budget)
        alloc_runs.append(time.time() - t0)
    alloc_s = alloc_runs[0]

    # best-of-2 on the estimation phase: identical device programs, so
    # the spread between the runs is noise; estimates come from run 1
    sample_runs = []
    mus = errs = None
    for rep in range(2):
        t0 = time.time()
        m, e, cost = problem.solve(K=K, budget=budget)
        sample_runs.append(time.time() - t0)
        if mus is None:
            mus, errs = m, e
    return (alloc_s, alloc_runs, min(sample_runs), sample_runs,
            total_evaluations(problem), mus, errs, budget)


def reference_outputs(xis, n, n_kl=None, sigma=None, nu=None):
    """Plain f64 numpy/scipy reference of one diffusion fidelity, written
    independently of models/diffusion.py: the KL field on the ``n`` cell
    faces (modes truncated to ``max(1, n // 4)`` as the hierarchy does),
    a banded LU solve of the flux-form FD system, and the three QoIs.
    xis: (S, n_kl) -> (S, 3) = (integral of u, u(1/2), energy)."""
    from scipy.linalg import solve_banded
    n_kl = N_KL if n_kl is None else n_kl
    sigma = SIGMA if sigma is None else sigma
    nu = NU if nu is None else nu
    xis = np.atleast_2d(np.asarray(xis, np.float64))
    h = 1.0 / n
    xf = (np.arange(n) + 0.5) * h
    k = np.arange(1, n_kl + 1)
    ck = sigma * k ** (-nu) * np.sqrt(2.0)
    keep = np.arange(n_kl) < max(1, n // 4)
    modes = np.sin(np.pi * xf[:, None] * k[None, :])
    fields = np.exp((xis * (ck * keep)) @ modes.T)        # (S, n)
    out = np.empty((len(xis), 3))
    for s, a in enumerate(fields):
        am, ap = a[:-1], a[1:]
        ab = np.zeros((3, n - 1))
        ab[0, 1:] = -ap[:-1] / h ** 2
        ab[1] = (am + ap) / h ** 2
        ab[2, :-1] = -am[1:] / h ** 2
        u = solve_banded((1, 1), ab, np.ones(n - 1))
        uu = np.concatenate([[0.0], u, [0.0]])
        out[s] = (h * np.sum(u), uu[n // 2],
                  h * np.sum(a * (np.diff(uu) / h) ** 2))
    return out


def numpy_model_eval(ls, xi):
    """Reference-architecture model evaluation: per-sample scipy banded
    solves (one per fidelity in the coupled group)."""
    return np.array([reference_outputs(xi, GRIDS[l])[0] for l in ls]).T


def run_baseline_sampling(problem):
    """Reference-architecture sampling cost (PROXY: the actual reference
    cannot run here -- no mpi4py/cvxopt -- so its per-sample Python loop
    with scipy banded solves, blue_fn.py:115-167, is re-created and priced
    deterministically).  Per-model unit costs are measured on fixed
    sample counts, the full allocation workload priced from them, and one
    full group tier is run WITHOUT extrapolation to validate the pricing.
    Returns (total_s, tier_check dict)."""
    rng = np.random.default_rng(0)
    reps = max(10, BASELINE_SAMPLE_CAP // len(GRIDS))
    t_model = []
    for l in range(len(GRIDS)):
        xis = rng.standard_normal((reps, N_KL))
        # best-of-3 chunked timing: per-model unit costs are the pricing
        # basis for the whole baseline, and a single pass is at the mercy
        # of transient machine load (observed 1.8x swings between runs)
        best_t = np.inf
        for _ in range(3):
            t0 = time.time()
            for r in range(reps):
                numpy_model_eval((l,), xis[r])
            best_t = min(best_t, (time.time() - t0) / reps)
        t_model.append(best_t)
    out = problem.MOSAP_output
    total = 0.0
    for g, n in zip(out["flattened_groups"], out["samples"]):
        total += int(n) * sum(t_model[l] for l in g)

    # exact (no extrapolation) runs of up to TWO distinct tiers predicted
    # <= ~15s, each best-of-2; the pricing anchor is the MEDIAN of the
    # per-tier measured/predicted ratios.  A single tier run drifted 26%
    # between rounds purely from machine load; the median of repeated
    # disjoint runs pins the anchor to ~+-15% (round-2 VERDICT item 8).
    candidates = sorted(
        ((list(g), int(n), int(n) * sum(t_model[l] for l in g))
         for g, n in zip(out["flattened_groups"], out["samples"])
         if 0 < int(n) * sum(t_model[l] for l in g) <= 15.0),
        key=lambda t: -t[2])[:2]
    tier_checks = []
    ratios = []
    for g, n, pred in candidates:
        runs = []
        for _ in range(2):
            xis = rng.standard_normal((n, N_KL))
            t0 = time.time()
            for r in range(n):
                numpy_model_eval(tuple(g), xis[r])
            runs.append(time.time() - t0)
        measured = min(runs)     # best-of-2: drop transient-load outliers
        ratios.append(measured / pred)
        tier_checks.append({"group": g, "n": n,
                            "predicted_s": round(pred, 3),
                            "measured_s": round(measured, 3),
                            "runs_s": [round(r, 3) for r in runs],
                            "ratio": round(measured / pred, 3)})
    if ratios:
        # anchor the priced total to the exact tier measurements: the
        # per-model unit timings drift with machine load run-to-run; the
        # tier runs are real uninterrupted executions of the largest
        # affordable slices of the actual workload
        total = total * float(np.median(ratios))
    return total, tier_checks


def _np_variance_gh(psi, m, nohess=False):
    """Reference-architecture variance/grad/Hessian in plain numpy
    (the algebra of misc.py:479-505, independent of the jitted stack)."""
    M = int(round(np.sqrt(psi.shape[0])))
    PHI = (psi @ m).reshape(M, M)
    invPHI = np.linalg.pinv(PHI, rcond=1e-12, hermitian=True)
    var = invPHI[0, 0]
    phi0 = invPHI[:, 0]
    A = psi.reshape(M, M, -1)
    W = np.einsum('mnl,n->lm', A, phi0)
    grad = -W @ phi0
    if nohess:
        return var, grad, None
    return var, grad, 2.0 * (W @ invPHI @ W.T)


def run_baseline_allocation(problem, quality_rtol=0.05):
    """Reference-architecture allocation solve (PROXY): scipy trust-constr
    on the budget-mode epigraph NLP with numpy variance/grad/Hessian --
    the reference's non-SDP solver path (sap.py:387-418, mosap.py:562-613)
    configured independently of bluest_tpu's own kernels.

    Time-to-comparable-quality protocol: at its default tolerance the NLP
    returns a point whose max variance is up to ~45% above the SDP
    optimum at the same budget (i.e. a 45% more expensive estimator), so
    timing it alone would flatter the baseline.  The solve is re-run at
    tighter tolerances until the max variance is within ``quality_rtol``
    of bluest_tpu's continuous optimum; the time of the first comparable
    solve is reported, with the achieved quality ratio.  Scope note: this
    is the continuous solve only (no integer projection, no structure
    construction), both of which bluest_tpu's alloc_s includes."""
    from scipy.optimize import minimize, LinearConstraint, \
        NonlinearConstraint, Bounds

    mos = problem.MOSAP
    budget = problem.MOSAP.budget
    L, No, w = mos.L, mos.n_outputs, mos.costs
    psis = [np.asarray(s.psi) for s in mos.SAPS]
    ours_mx = None
    if getattr(mos, "continuous_solution", None) is not None:
        ours_mx = max(mos.variances(np.maximum(
            np.asarray(mos.continuous_solution, float), 0)))
    bounds = Bounds(np.zeros(L + 1), np.inf * np.ones(L + 1),
                    keep_feasible=True)
    cons = [LinearConstraint(np.concatenate([[0], w]), -np.inf, budget)]
    for n in range(No):
        ee = np.zeros(L + 1)
        ee[1 + mos.mappings[n]] = mos.e[mos.mappings[n]]
        cons.append(LinearConstraint(ee, 1, np.inf, keep_feasible=True))

    def make_epi(nn):
        mp = mos.mappings[nn]
        psi = psis[nn]

        def f(x):
            return x[0] - _np_variance_gh(psi, x[1:][mp], nohess=True)[0]

        def jac(x):
            g = np.zeros(L + 1); g[0] = 1.0
            g[1 + mp] = -_np_variance_gh(psi, x[1:][mp], nohess=True)[1]
            return g

        def hess(x, v):
            Hn = _np_variance_gh(psi, x[1:][mp])[2]
            out = np.zeros((L + 1, L + 1))
            out[np.ix_(1 + mp, 1 + mp)] = -Hn
            return float(np.atleast_1d(v)[0]) * out

        return NonlinearConstraint(f, 0, np.inf, jac=jac, hess=hess)

    cons += [make_epi(n) for n in range(No)]
    m0 = np.full(L, budget / w.sum())
    t0v = max(_np_variance_gh(psis[n], m0[mos.mappings[n]], nohess=True)[0]
              for n in range(No))
    x0 = np.concatenate([[t0v], m0])
    eee = np.zeros(L + 1); eee[0] = 1.0

    elapsed = None
    quality = None
    xb = None
    x_start = x0
    for tol in (1e-7, 1e-9, 1e-11):
        t0 = time.time()
        r = minimize(lambda x: (x[0], eee), x_start, jac=True,
                     hessp=lambda x, p: np.zeros(L + 1), bounds=bounds,
                     constraints=cons, method="trust-constr",
                     options={"maxiter": 1000}, tol=tol)
        elapsed = time.time() - t0
        xb = r.x[1:]
        # warm-started continuation (interiorized to keep trust-constr's
        # strict-feasibility start valid): the baseline's best shot
        x_start = 0.99 * np.maximum(r.x, 0) + 0.01 * x0
        x_start[0] = max(
            1.0001 * max(_np_variance_gh(psis[n], x_start[1:][mos.mappings[n]],
                                         nohess=True)[0] for n in range(No)),
            x_start[0])
        if ours_mx is None:
            quality = None
            break
        mx = max(mos.variances(np.maximum(xb, 0)))
        quality = float(mx / ours_mx)
        if quality <= 1.0 + quality_rtol:
            break
    return elapsed, xb, quality


def main():
    quick = "--quick" in sys.argv
    global GRIDS, TARGET_SAMPLES, PILOT, BASELINE_SAMPLE_CAP
    if quick:
        GRIDS = (64, 32, 16, 8)
        TARGET_SAMPLES = 50_000
        PILOT = 512
        BASELINE_SAMPLE_CAP = 200
    platform, dev_kind, n_dev = device_info()
    peaks = device_peaks(platform, dev_kind)
    card = nvidia_smi(*CARD_QUERY)
    sys.stderr.write("bench device: platform=%s device_kind=%s count=%d "
                     "card=%s\n" % (platform, dev_kind, n_dev,
                                     "; ".join(card) if card else "n/a"))

    problem = build_problem()
    alloc_s, alloc_runs, sample_s, sample_runs, n_evals, mus, errs, budget \
        = run_bluest_tpu(problem)
    n_samples = total_samples(problem)
    ipm = ipm_report(problem)

    # flops / roofline accounting for the estimation phase (the sampling
    # programs execute on the default device; helpers documented above)
    model_flops, model_bytes = sampling_flops(problem)
    achieved_fs = model_flops / max(sample_s, 1e-9)
    not_measured = "not measured"

    def share(value, peak_key):
        return not_measured if peaks is None else round(
            value / peaks[peak_key], 5)

    def hbm_gb_s(n_bytes, seconds):
        # the byte model's device-memory rate; no such memory on the CPU
        return not_measured if peaks is None else round(
            n_bytes / max(seconds, 1e-9) / 1e9, 1)

    # one f64 estimation rep for the record: the headline sampling runs
    # the MODEL in f32 (estimator sums always accumulate in f64) while
    # the library default and the priced numpy baseline are f64 -- this
    # rep states the precision cost instead of leaving the comparison
    # precision-mismatched (VERDICT r3 item 7)
    p64 = build_problem(f64=True)
    p64.setup_solver(K=K, budget=budget)
    runs64 = []
    for _ in range(2):
        t0 = time.time()
        p64.solve(K=K, budget=budget)
        runs64.append(time.time() - t0)
    sample_s_f64 = min(runs64)

    base_alloc_s, _, base_alloc_quality = run_baseline_allocation(problem)
    base_sample_s, tier_checks = run_baseline_sampling(problem)
    baseline = base_alloc_s + base_sample_s

    # warm re-solve at a fresh budget: what a user pays once programs are
    # compiled and the budget ray is cached (separates the compile-cache
    # tax from the steady-state allocation cost).  Runs AFTER the
    # baseline pricing so the baselines price the HEADLINE allocation
    # (this re-solve replaces MOSAP_output).
    t0 = time.time()
    problem.setup_solver(K=K, budget=1.1 * float(problem.MOSAP.budget or 1.0))
    alloc_warm_s = time.time() - t0

    # saturated-throughput tier (VERDICT r4 item 1b): the headline
    # workload (~1.2M evals over ~14 group programs) carries a fixed
    # dispatch/fetch cost across the portfolio, so its evals/s reads
    # under the engine's steady rate.  Re-solve at ~20x the budget and
    # time the estimation phase once more so the saturated operating
    # point is a RECORDED number, not a comment.
    sat = None
    if not quick:
        problem.setup_solver(K=K, budget=20.0 * budget)
        n_evals_sat = total_evaluations(problem)
        sat_runs = []
        for _ in range(2):
            t0 = time.time()
            problem.solve(K=K, budget=20.0 * budget)
            sat_runs.append(time.time() - t0)
        sat_s = min(sat_runs)
        sat_flops, sat_bytes = sampling_flops(problem)
        sat = {
            "n_model_evals": n_evals_sat,
            "sample_s": round(sat_s, 3),
            "runs_s": [round(s, 3) for s in sat_runs],
            "evals_per_s": round(n_evals_sat / max(sat_s, 1e-9)),
            "achieved_gflops": round(
                sat_flops / max(sat_s, 1e-9) / 1e9, 2),
            "mfu": share(sat_flops / max(sat_s, 1e-9), "flops"),
            "hbm_gb_s_est": hbm_gb_s(sat_bytes, sat_s),
        }

    # steady-state headline: rebuild alloc + sampling
    ours = alloc_runs[1] + sample_s

    result = {
        "metric": ("mosap_alloc_rebuild_plus_%.0esample_estimation_wall"
                   % TARGET_SAMPLES),
        "value": round(ours, 3),
        "unit": "s",
        "vs_baseline": round(baseline / ours, 2),
        "alloc_rebuild_s": round(alloc_runs[1], 3),
        "alloc_warm_s": round(alloc_warm_s, 3),
        "alloc_cold_s": round(alloc_runs[0], 3),
        "sample_s": round(sample_s, 3),
        "evals_per_s": round(n_evals / max(sample_s, 1e-9)),
        "max_rel_err": float(np.max(errs) / abs(mus[0])),
        "device": {"platform": platform, "kind": dev_kind,
                   "count": n_dev, "card": card},
        "model_dtype": "float32",
        "mfu": share(achieved_fs, "flops"),
        "detail": {
            "value_cold_semantics": round(alloc_runs[0] + sample_s, 3),
            "sample_runs_s": [round(s, 3) for s in sample_runs],
            "sample_s_f64": round(sample_s_f64, 3),
            "sample_f64_runs_s": [round(s, 3) for s in runs64],
            "n_model_evals": n_evals,
            "n_samples": n_samples,
            "model_flops_est": round(model_flops),
            "achieved_gflops": round(achieved_fs / 1e9, 2),
            "mfu_basis": (not_measured if peaks is None else
                          "%s f32 peak %.0f TF/s (%s)"
                          % (dev_kind, peaks["flops"] / 1e12, _PEAK_SOURCE)),
            "hbm_gb_s_est": hbm_gb_s(model_bytes, sample_s),
            "hbm_peak_gb_s": (not_measured if peaks is None
                              else peaks["hbm_gb_s"]),
            "sampling_path": {
                "portfolio_sweep": os.environ.get(
                    "BLUEST_TPU_PORTFOLIO_SWEEP", "0") == "1",
            },
            "saturated_tier": sat,
            "ipm": ipm,
            "baseline_kind": ("reference-architecture PROXY on this host "
                              "(per-sample scipy loop + trust-constr NLP "
                              "at matched solution quality -- see "
                              "baseline_alloc_quality; the real reference "
                              "needs mpi4py/cvxopt)"),
            "baseline_alloc_s": round(base_alloc_s, 3),
            "baseline_alloc_quality": (None if base_alloc_quality is None
                                       else round(base_alloc_quality, 4)),
            "baseline_sample_s_priced": round(base_sample_s, 3),
            "baseline_tier_check": tier_checks,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
