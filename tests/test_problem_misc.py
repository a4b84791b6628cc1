"""Coverage for the remaining BLUEProblem behaviors: complexity test,
node reordering, batched host sampling, skip_projection, wall-time cost
estimation, per-model sample caps through the problem API."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bluest_tpu import BLUEProblem
from bluest_tpu.models.analytic import ExpSeriesProblem, default_costs


@pytest.fixture(scope="module")
def problem():
    return ExpSeriesProblem(4, covariance_estimation_samples=4096,
                            verbose=False)


def test_complexity_test(problem):
    """Cost vs eps rate fit (reference blue_models.py:932-942): halving
    eps must raise cost; rate near 2 for an MC-dominated hierarchy."""
    C00 = problem.get_covariance()[0, 0]
    eps = [0.1 * np.sqrt(C00) / 2 ** i for i in range(3)]
    tot_cost, rate = problem.complexity_test(eps, K=3)
    assert np.all(np.diff(tot_cost) > 0)
    assert 1.0 < rate < 3.0  # eps^-2 scaling in log2 per halving


def test_reorder_graph_nodes():
    p = ExpSeriesProblem(4, covariance_estimation_samples=512, verbose=False)
    C_before = p.get_covariance().copy()
    costs_before = p.get_costs().copy()
    order = [3, 2, 1, 0]
    p.reorder_all_graph_nodes(order)
    C_after = p.get_covariance()
    np.testing.assert_allclose(C_after,
                               C_before[np.ix_(order, order)], rtol=1e-12)
    np.testing.assert_allclose(p.get_costs(), costs_before[order])


def test_host_batched_sampler():
    """sample_batch_size > 1 with a batch-aware sampler/evaluate
    (reference blue_fn.py:112-167)."""

    class BatchProblem(BLUEProblem):
        def __init__(self, *a, **k):
            self._rng = np.random.default_rng(3)
            super().__init__(*a, **k)

        def sampler(self, ls, N=1):
            z = self._rng.standard_normal(N)
            return [z for _ in ls]

        def evaluate(self, ls, samples, N=1):
            return [[np.exp(samples[i]) / (l + 1) for i, l in enumerate(ls)]]

    C = np.eye(2) + 0.5
    p = BatchProblem(2, C=C.copy(), costs=np.array([2.0, 1.0]),
                     sample_batch_size=64, verbose=False)
    sumse, sumsc, cost = p.blue_fn([0, 1], 1000, verbose=False)
    assert abs(sumse[0][0] / 1000 - np.exp(0.5)) < 0.3
    assert sumsc[0].shape == (2, 2)


def test_skip_projection():
    rng = np.random.default_rng(9)
    A = rng.standard_normal((3, 3))
    C = A @ A.T + 1e-8 * np.eye(3)

    p = ExpSeriesProblem(3, C=C.copy(), costs=default_costs(3),
                         skip_projection=True, verbose=False)
    np.testing.assert_allclose(p.get_covariance(), C, rtol=1e-12)


def test_estimate_costs_walltime():
    """Costs estimated from wall time when not provided
    (reference blue_models.py:435-441)."""
    p = ExpSeriesProblem(3, covariance_estimation_samples=256, verbose=False)
    # now rebuild without costs: wall-time estimation must produce
    # positive, finite costs
    class NoCosts(ExpSeriesProblem):
        def __init__(self, n_models=3, **k):
            k.pop("costs", None)
            self.n_models = n_models
            BLUEProblem.__init__(self, n_models,
                                 covariance_estimation_samples=128,
                                 verbose=False, **k)

    p2 = NoCosts()
    w = p2.get_costs()
    assert np.all(w > 0) and np.all(np.isfinite(w))


def test_max_model_samples_through_problem():
    p = ExpSeriesProblem(4, covariance_estimation_samples=2048,
                         verbose=False)
    budget = 200 * 2.0 ** 4
    mms = np.inf * np.ones(4)
    mms[-1] = 50.0
    blue = p.setup_solver(K=2, budget=budget, max_model_samples=mms)
    samples = p.MOSAP_output["samples"]
    groups = p.MOSAP_output["flattened_groups"]
    n_last = sum(int(n) for g, n in zip(groups, samples) if 3 in g)
    assert n_last <= 50


def test_get_model_graph_sentinels():
    """Reference get_model_graph surface (blue_models.py:232-263):
    sentinel semantics preserved through the mask-based graph."""
    from bluest_tpu import BLUEProblem

    class P(BLUEProblem):
        pass

    C_known = np.eye(3) + 0.5
    p = P(3, C=C_known, costs=np.array([4.0, 2.0, 1.0]), verbose=False)
    C = np.array([[2.0, np.nan, np.inf],
                  [np.nan, 1.0, 0.0],
                  [np.inf, 0.0, 1.0]])
    G = p.get_model_graph(C.copy())
    back = G.covariance()
    assert np.isnan(back[0, 1])        # to-estimate stays NaN
    assert back[1, 2] == 0.0           # uncorrelated stays 0
    assert np.isnan(back[0, 2]) or np.isinf(back[0, 2])  # uncouplable


def test_prewarm_solver_shape_contract():
    """prewarm_solver must predict EXACTLY the group count setup_solver
    builds (else the warmed trace is wasted and the solve retraces)."""
    import numpy as np
    from bluest_tpu.models.analytic import ExpSeriesProblem
    from bluest_tpu.solvers import sdp

    C = np.eye(5) + 0.5
    C[0, 4] = C[4, 0] = np.inf     # uncouplable pair prunes cliques
    p = ExpSeriesProblem(5, C=C, costs=np.array([16.0, 8, 4, 2, 1]),
                         verbose=False)
    L_pred = p.prewarm_solver(K=3)
    # prewarm_solver constructs the full MOSAP through the structure
    # cache, so the later setup_solver must REUSE the same object (psi
    # assembly off the timed path)
    warmed_mosap = p.MOSAP
    assert warmed_mosap is not None and warmed_mosap.L == L_pred
    blue = p.setup_solver(K=3, budget=500.0)
    assert p.MOSAP is warmed_mosap
    assert L_pred == len(blue["models"]) or L_pred == p.MOSAP.L
    assert p.MOSAP.L == L_pred
    # and the shape really is in the warmed set
    assert (L_pred, 1, 6, False, 0) in sdp._WARMED

    # capped budget mode traces the budget-epigraph + cap-rows program:
    # prewarm with the matching hints must register exactly that form
    mms = np.array([np.inf, 10000.0, np.inf, 20000.0, np.inf])
    L2 = p.prewarm_solver(K=3, budget=500.0, max_model_samples=mms)
    assert (L2, 1, 6, True, 2) in sdp._WARMED


def test_prewarm_forms_for_dispatch_logic():
    """prewarm_forms_for must mirror sdp_solve's program dispatch."""
    from bluest_tpu.allocation.mosap import prewarm_forms_for

    caps = [np.inf, 50.0, 100.0]
    # budget, no caps: direct-eps ray only
    assert prewarm_forms_for(10.0, None, 1000) == [(False, 0)]
    # budget + caps: budget-epigraph with one row per finite cap, plus
    # the direct-eps-with-caps bisection rescue and its 0-cap level probe
    assert prewarm_forms_for(10.0, caps, 1000) == [
        (True, 2), (False, 2), (False, 0)]
    # eps, no caps, large L: direct-eps only (no epigraph cross-check)
    assert prewarm_forms_for(None, None, 1000) == [(False, 0)]
    # eps, no caps, small L: direct-eps + the epigraph cross-check
    assert prewarm_forms_for(None, None, 400) == [(False, 0), (True, 0)]
    # eps + caps: direct-eps with cap rows
    assert prewarm_forms_for(None, caps, 1000) == [(False, 2)]
    # non-IPM solvers never trace a cone program
    assert prewarm_forms_for(10.0, None, 1000, solver="scipy") == []
    assert prewarm_forms_for(None, caps, 1000, solver="spg") == []


def test_default_sampler_batched_remainder():
    """The engine's default sampler under a batched loop (N1 > 1) must
    return length-N sequences on EVERY chunk -- the reference convention
    (blue_fn.py:85-89) -- or an N % N1 == 1 remainder chunk crashes on
    Ps[n][i][w] with a bare float."""
    from bluest_tpu.sampling import host_engine

    class Stub:
        def evaluate(self, ls, samples, N=1):
            # batch-aware evaluate: samples[i] is a length-N sequence
            return [[np.asarray(samples[i]) * (l + 1.0)
                     for i, l in enumerate(ls)]]

    # N=5, N1=2 -> chunks 2,2,1: the final chunk used to get a float draw
    sumse, sumsc, cost = host_engine.blue_fn(
        [0, 1], 5, Stub(), sampler=None, N1=2, verbose=False)
    assert np.isfinite(sumse[0][0])
    assert sumsc[0].shape == (2, 2)


def test_snapshot_filename_path_handling():
    """Reference naming (basename + models + ext, blue_fn.py:98-101) must
    split only the BASENAME's extension: dotted parent directories and
    extensionless names both mangled the target path before."""
    from bluest_tpu.sampling.snapshots import snapshot_filename
    assert snapshot_filename("snap.npz", [0, 2]) == "snap02.npz"
    assert snapshot_filename("out.v2/snap.npz", [1]) == "out.v2/snap1.npz"
    assert snapshot_filename("samples", [0, 1]) == "samples01"
    assert snapshot_filename("run.d/samples", [3]) == "run.d/samples3"


def test_plot_snapshots_tool_reads_engine_output(tmp_path):
    """tools/plot_snapshots.py (the reference plot_histograms analog)
    must load and summarize engine-written snapshot files."""
    import sys
    sys.path.insert(0, "tools")
    try:
        from plot_snapshots import load_snapshot, summarize
    finally:
        sys.path.pop(0)
    import io
    from bluest_tpu.models.analytic import ExpSeriesProblem
    snap = str(tmp_path / "snap.npz")
    p = ExpSeriesProblem(3, C=np.eye(3) + 0.5,
                         costs=np.array([4.0, 2.0, 1.0]),
                         verbose=False, samplefile=snap)
    p.blue_fn([0, 2], 64)
    s = load_snapshot(str(tmp_path / "snap02.npz"))
    assert s["models"] == [0, 2] and s["n_samples"] == 64
    assert s["values"][(0, 0)].shape[0] == 64
    buf = io.StringIO()
    summarize(s, stream=buf)
    assert "model 2" in buf.getvalue()


def test_host_engine_bounded_resample():
    """A black-box model that intermittently fails still completes; one
    that ALWAYS returns non-finite raises instead of hanging forever
    (the reference loops forever, blue_fn.py:118-129)."""
    import itertools
    from bluest_tpu.sampling import host_engine

    class Flaky:
        params = {"max_resample": 8}
        counter = itertools.count()

        def evaluate(self, ls, samples, N=1):
            # every third evaluation fails
            bad = next(self.counter) % 3 == 0
            return [[np.nan if bad else float(samples[i])
                     for i in range(len(ls))]]

    def sampler(ls):
        return [1.0 for _ in ls]

    sumse, sumsc, cost = host_engine.blue_fn(
        [0, 1], 10, Flaky(), sampler=sampler, verbose=False)
    assert sumse[0][0] == pytest.approx(10.0)

    class AlwaysBad(Flaky):
        def evaluate(self, ls, samples, N=1):
            return [[np.nan for _ in ls]]

    with pytest.raises(RuntimeError, match="consecutive attempts"):
        host_engine.blue_fn([0, 1], 4, AlwaysBad(), sampler=sampler,
                            verbose=False)
