"""Multi-output Hodgkin-Huxley example (the reference paper's
12-model, 5-output configuration, blue_hodgkin-huxley.py): mixed
integrator fidelities (RK4/Euler timesteps) and a FitzHugh-Nagumo
reduction, estimated jointly for five QoIs.

Run:  python examples/multi_output_hodgkin_huxley.py [--full|--fast]
(--full uses all 12 models; default is a 6-model subset to keep compile
time reasonable on first run.  On CPU the default config takes ~7 min,
dominated by the ODE pilot; --fast shrinks the pilot to 256 samples for
a smoke run at a fraction of that (noisier covariance, looser
allocation).  On a GPU the sampling phase time is not measured yet.)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bluest_tpu.models.hodgkin_huxley import (DEFAULT_MODELS,
                                              HodgkinHuxleyProblem)

models = DEFAULT_MODELS if "--full" in sys.argv else (
    (0, 0.02), (0, 0.04), (1, 0.02), (1, 0.04), (2, 0.02), (2, 0.04))
pilot = 256 if "--fast" in sys.argv else 1024

problem = HodgkinHuxleyProblem(models=models,
                               covariance_estimation_samples=pilot,
                               device_batch_size=pilot, verbose=False)

print("costs:", np.round(problem.get_costs(), 2))
print("rho(output 0):", np.round(problem.get_correlation(0)[0], 3))

eps = [0.05 * np.sqrt(problem.get_covariance(n)[0, 0])
       for n in range(problem.n_outputs)]
blue = problem.setup_solver(K=3, eps=eps)
print("\nMLBLUE groups:", blue["models"])
print("total cost:", blue["total_cost"])
mus, errs, cost = problem.solve(K=3, eps=eps)
print("estimates:", [float(m) for m in mus])
print("errors:   ", errs)
