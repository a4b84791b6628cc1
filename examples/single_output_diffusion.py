"""Single-output stochastic diffusion example (the reference's
single_output_example.py pattern): estimate E[int u] for the lognormal
diffusion hierarchy; compare MC / MLMC / MFMC / MLBLUE at equal tolerance
and optionally run the statistical validation tests.

Run:  python examples/single_output_diffusion.py [--tests]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bluest_tpu.models.diffusion import DiffusionProblem

comparison_test = True
variance_test = "--tests" in sys.argv
complexity_test = "--tests" in sys.argv

problem = DiffusionProblem(grids=(256, 64, 16, 4), n_kl=32, sigma=1.0,
                           nu=0.6, covariance_estimation_samples=4096,
                           verbose=False)

C = problem.get_covariance()
print("correlations with model 0:", np.round(problem.get_correlation()[0], 4))
eps = 0.02 * np.sqrt(C[0, 0])

if comparison_test:
    mlmc = problem.setup_mlmc(eps=eps)
    mfmc = problem.setup_mfmc(eps=eps)
    blue = problem.setup_solver(K=4, eps=eps)
    print("\nCost at eps=%.3g:  MLMC %.0f   MFMC %.0f   MLBLUE %.0f"
          % (eps, mlmc["total_cost"], mfmc["total_cost"],
             blue["total_cost"]))
    mu, errs, cost = problem.solve(K=4, eps=eps)
    print("MLBLUE estimate: %.6f +- %.2g (cost %.0f)"
          % (mu[0], errs[0], cost))

if complexity_test:
    tot_cost, rate = problem.complexity_test(
        [eps * 2 ** (1 - i) for i in range(3)], K=3)
    print("complexity rate (log2 cost per eps halving):", rate)

if variance_test:
    err_ex, err = problem.variance_test(eps=eps * 2, K=3, N=30)
    print("variance test: predicted", err_ex, "empirical", err)
