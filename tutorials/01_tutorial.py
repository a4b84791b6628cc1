"""bluest_tpu tutorial — the reference walkthrough.

Estimates E[e^Z], Z ~ N(0,1), with a hierarchy of truncated exponential
series (reference tutorials/01_tutorial.py).  Runs on CPU or GPU; on a
multi-device host set mesh="auto" to shard the sampling.

Run:  python tutorials/01_tutorial.py

The walkthrough compiles one sampling kernel per estimator section, so
the first run is dominated by compilation; compiled programs land in the
persistent XLA cache and repeat runs are much faster.
"""

import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax
import jax.numpy as jnp

from bluest_tpu import BLUEProblem
n_models = 5


class MyProblem(BLUEProblem):
    """Factored JAX model: theta = Z shared by all coupled fidelities."""

    def sample_input_jax(self, key):
        return jax.random.normal(key)

    def evaluate_model_jax(self, l, z):
        if l == 0:
            return jnp.exp(z)[None]
        n_terms = n_models - l
        ii = jnp.arange(n_terms + 1, dtype=jnp.float64)
        fact = jnp.exp(jax.lax.lgamma(ii + 1.0))
        return jnp.sum(z ** ii / fact)[None]


costs = np.array([2.0 ** (n_models - i) for i in range(n_models)])

# ---------------- Part 1: basic usage ----------------------------------- #

problem = MyProblem(n_models, costs=costs,
                    covariance_estimation_samples=4096, verbose=False)

print("Covariance matrix:\n", problem.get_covariance())
print("\nCorrelation matrix:\n", problem.get_correlation())
print("\nCost vector:\n", problem.get_costs())

# 2% of the output std-dev keeps the tutorial fast; tighten to taste
eps = 0.02 * np.sqrt(problem.get_covariance()[0, 0])

sol_mc = problem.solve_mc(eps=eps)
print("\nStd MC solution:", sol_mc[0], " cost:", sol_mc[2])

mlmc_data = problem.setup_mlmc(eps=eps)
sol_mlmc = problem.solve_mlmc(eps=eps, mlmc_data=mlmc_data)
print("MLMC models:", mlmc_data["models"], " cost:", mlmc_data["total_cost"])
print("MLMC solution:", sol_mlmc[0])

mfmc_data = problem.setup_mfmc(eps=eps)
sol_mfmc = problem.solve_mfmc(eps=eps, mfmc_data=mfmc_data)
print("MFMC models:", mfmc_data["models"], " cost:", mfmc_data["total_cost"])
print("MFMC solution:", sol_mfmc[0])

blue_data = problem.setup_solver(K=n_models, eps=eps)
sol_blue = problem.solve(K=n_models, eps=eps)
print("MLBLUE groups:", blue_data["models"], " cost:", blue_data["total_cost"])
print("MLBLUE solution:", sol_blue[0])
print("\nCost comparison. MLMC: %.0f, MFMC: %.0f, MLBLUE: %.0f"
      % (mlmc_data["total_cost"], mfmc_data["total_cost"],
         blue_data["total_cost"]))

# user-prescribed groups
groups = [[0], [1], [0, 3], [3, 4], [0, 1, 2, 3, 4]]
blue_data = problem.setup_solver(groups=groups, eps=eps)
print("\nUser groups selected:", blue_data["models"])

# budget mode
budget = 100 * max(costs)
blue_data = problem.setup_solver(K=n_models, budget=budget)
print("Budget-mode cost:", blue_data["total_cost"], "<= budget", budget)

# solver selection and parameters (reference cvxopt/cvxpy names accepted;
# both map to the JAX interior-point SDP, "scipy"/"ipopt" to the NLP
# path, and "spg" to the projected spectral-gradient path -- three
# algorithmically independent families for cross-validation)
problem.setup_solver(K=n_models, budget=budget, solver="sdp",
                     optimization_solver_params={"tol": 1e-8})
problem.setup_solver(K=n_models, budget=budget, solver="scipy")
problem.setup_solver(K=n_models, budget=budget, solver="spg")

# every cone solve records its interior-point certificate, and an
# independent first-order KKT verifier re-checks the continuous optimum
# (the role cross-vendor solver comparisons play in the reference)
problem.setup_solver(K=n_models, budget=budget)
cert = min(problem.MOSAP_output["certificates"],
           key=lambda c: max(c["relgap"], c["pres"], c["dres"]))
kkt = problem.MOSAP.kkt_certificate()
print("SDP certificate: %s (relgap %.1e); KKT stationarity %.1e"
      % (cert["status"], cert["relgap"], kkt["stationarity"]))

# ---------------- Part 2: persistence ----------------------------------- #

tmp = "/tmp/bluest_tpu_tutorial"
shutil.rmtree(tmp, ignore_errors=True)
os.makedirs(tmp, exist_ok=True)

problem.save_graph_data(os.path.join(tmp, "data.npz"))
problem2 = MyProblem(n_models, datafile=os.path.join(tmp, "data.npz"),
                     verbose=False)
assert np.allclose(problem2.get_covariance(), problem.get_covariance(),
                   equal_nan=True)

# known covariance skips pilot sampling entirely
C = np.random.randn(n_models, n_models); C = C.T @ C
problem3 = MyProblem(n_models, C=C.copy(), costs=costs, verbose=False)

# NaN = re-estimate, inf = never couple (reference sentinel semantics)
C2 = np.nan * np.ones((n_models, n_models))
C2[0, 1] = C2[1, 0] = np.inf
problem4 = MyProblem(n_models, C=C2, costs=costs,
                     covariance_estimation_samples=1024, verbose=False)
out = problem4.setup_solver(K=3, eps=eps)
assert all(not (0 in g and 1 in g) for g in out["models"])

# ---------------- Part 3: multiple outputs ------------------------------ #


class MyMultiProblem(BLUEProblem):
    def sample_input_jax(self, key):
        return jax.random.normal(key)

    def evaluate_model_jax(self, l, z):
        if l == 0:
            v = jnp.exp(z)
        else:
            n_terms = n_models - l
            ii = jnp.arange(n_terms + 1, dtype=jnp.float64)
            v = jnp.sum(z ** ii / jnp.exp(jax.lax.lgamma(ii + 1.0)))
        return jnp.stack([v, v * v])


mproblem = MyMultiProblem(n_models, n_outputs=2, costs=costs,
                          covariance_estimation_samples=4096, verbose=False)
eps2 = [0.02 * np.sqrt(mproblem.get_covariance(n)[0, 0]) for n in range(2)]
mblue = mproblem.setup_solver(K=n_models, eps=eps2)
mus, errs, cost = mproblem.solve(K=n_models, eps=eps2)
print("\nMulti-output MLBLUE: mus =", mus, " errors =", errs)
print("(exact: E[e^Z] = %.6f, E[e^2Z] = %.6f)"
      % (np.exp(0.5), np.exp(2.0)))

# statistical self-validation (reference variance_test)
err_ex, err = mproblem.variance_test(eps=eps2, K=3, N=10)
print("\nvariance_test: predicted", err_ex, "empirical", err)

# ---------------- Part 4: sample snapshots ------------------------------- #
# samplefile streams every model output and raw input sample to npz files
# (reference tutorial 01_tutorial.py:244-259) -- one file per coupled
# group, named basename + model indices + extension, appended across runs.
# outputs_to_save filters which outputs are stored.

mproblem.params["samplefile"] = os.path.join(tmp, "snaps.npz")
mproblem.params["outputs_to_save"] = [0]      # store output 0 only
mproblem.solve(K=2, eps=[4 * e for e in eps2])
snap_files = sorted(f for f in os.listdir(tmp) if f.startswith("snaps"))
d = dict(np.load(os.path.join(tmp, snap_files[0]), allow_pickle=True))
print("\nSnapshot files:", snap_files)
print("First file: models %s, %d samples, keys %s"
      % (list(d["models"][0]), int(d["n_samples"][0]),
         sorted(k for k in d if k.startswith("values"))))
mproblem.params["samplefile"] = None          # turn streaming back off
mproblem.params["outputs_to_save"] = None

# ---------------- Part 5: black-box (non-JAX) models --------------------- #
# Any plain-Python simulator works unchanged through the host engine:
# override sampler/evaluate instead of the *_jax hooks.  sample_batch_size
# passes N samples per evaluate call when the overloads accept a batch
# argument (reference blue_fn.py:112-167); spg_params tunes the SPG
# covariance-projection optimizer (reference blue_models.py:13-20).


class MyHostProblem(BLUEProblem):
    def sampler(self, ls, N=1):
        z = np.random.randn(N)                # batched: N samples at once
        return [z for _ in range(len(ls))]

    def evaluate(self, ls, samples, N=1):
        out = []
        for i, l in enumerate(ls):
            z = np.asarray(samples[i])
            if l == 0:
                v = np.exp(z)
            else:
                n_terms = n_models - l
                ii = np.arange(n_terms + 1)[:, None]
                v = np.sum(z[None, :] ** ii
                           / np.cumprod(np.maximum(ii, 1), axis=0), axis=0)
            out.append(v)
        return [out]

hproblem = MyHostProblem(n_models, costs=costs,
                         covariance_estimation_samples=1024,
                         sample_batch_size=256,         # vectorized batches
                         spg_params={"maxit": 500},     # projection budget
                         verbose=False)
sol_host = hproblem.solve_mc(eps=4 * eps)
print("\nBlack-box host model, std MC:", sol_host[0])

# ---------------- Part 6: multi-device sampling -------------------------- #
# mesh="auto" shards the sample axis over every visible device with a psum
# merge -- the reference's `mpiexec -n P` (tutorial 01_tutorial.py:140-172)
# with no launcher and deterministic per-sample keys.  On a single-device
# host it is a no-op; run under XLA_FLAGS=--xla_force_host_platform_device
# _count=8 (or on a multi-GPU host) to see the sharding.

dproblem = MyProblem(n_models, costs=costs, mesh="auto",
                     covariance_estimation_samples=4096, verbose=False)
sol_dev = dproblem.solve(K=3, eps=eps)
print("\nmesh='auto' over %d device(s): MLBLUE solution %s"
      % (len(jax.devices()), sol_dev[0]))

print("\nTutorial completed.")
