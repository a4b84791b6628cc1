"""Navier-Stokes paper study, end-to-end runnable.

Re-creates the reference's 12-model 6-output Navier-Stokes study
(examples/paper_examples/navier_stokes/bluest_NS.py) from its committed
model-graph npz:

  1. OFFLINE (exactly the reference workflow): load the npz through the
     reference-format reader, set up MLBLUE / MLMC / MFMC at the study's
     tolerance, and print the cost comparison the paper reports
     (plot_histograms.py:58-65: BLUE 2.55M < MFMC 4.34M < MLMC 6.58M in
     cost units at the paper's K=7; at K=3 here the ordering already
     holds).

  2. ONLINE: the original FEniCS flow solver cannot run here, so the
     sampling phase runs on a Gaussian surrogate whose per-output model
     covariance EQUALS the loaded C_n (P_n = mu_n + chol(C_n) z with a
     shared latent z ~ N(0, I_12)), evaluated through the device kernel
     engine.  The known means make the estimator error measurable: the
     run asserts |mu_hat_n - mu_n| stays within the predicted RMSE.

Run:  python examples/navier_stokes_study.py          (GPU or CPU)
      JAX_PLATFORMS=cpu python examples/navier_stokes_study.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

NS_NPZ = ("/root/reference/examples/paper_examples/navier_stokes/"
          "NS_model_data_full.npz")
K = 3
TRUE_MEANS = np.arange(1.0, 7.0)     # known surrogate means per output


def main():
    import jax
    import jax.numpy as jnp

    from bluest_tpu import BLUEProblem

    if not os.path.exists(NS_NPZ):
        print("reference NS npz not mounted at", NS_NPZ)
        return

    # ---------------- offline: the paper's allocation study -------------- #
    class NSOffline(BLUEProblem):
        pass

    p = NSOffline(12, n_outputs=6, datafile=NS_NPZ, verbose=True)
    C = p.get_covariances()
    eps = 1e-3 * np.sqrt([c[0, 0] for c in C])   # bluest_NS.py:121

    blue = p.setup_solver(K=K, eps=eps)
    mlmc = p.setup_mlmc(eps=eps)
    mfmc = p.setup_mfmc(eps=eps)
    print("\nAllocation costs at the study tolerance (cost units):")
    print("  MLBLUE (K=%d): %12.1f" % (K, blue["total_cost"]))
    print("  MFMC:          %12.1f" % mfmc["total_cost"])
    print("  MLMC:          %12.1f" % mlmc["total_cost"])
    print("  savings vs MLMC: %.2fx, vs MFMC: %.2fx"
          % (mlmc["total_cost"] / blue["total_cost"],
             mfmc["total_cost"] / blue["total_cost"]))

    if "--solver-test" in sys.argv:
        # the reference's solver_test block (bluest_NS.py:124-140):
        # time every continuous solver on the same instance and compare
        # the resulting max-variance at a common budget
        import time
        budget = blue["total_cost"]
        mos = p.MOSAP
        print("\nsolver_test at budget %.0f:" % budget)
        for name in ("sdp", "scipy", "spg"):
            t0 = time.time()
            m = mos.solve(budget=budget, solver=name,
                          continuous_relaxation=True)
            dt = time.time() - t0
            if m is None:
                print("  %-6s FAILED (%.2fs)" % (name, dt))
                continue
            mx = max(mos.variances(np.maximum(np.asarray(m, float), 0)))
            print("  %-6s %7.2fs  max variance %.6e" % (name, dt, mx))
            mos._ray_cache = {}        # time each solver cold

    # ---------------- online: Gaussian surrogate sampling ---------------- #
    Ls = [np.linalg.cholesky(c + 1e-10 * np.trace(c) / 12 * np.eye(12))
          for c in C]

    class NSSurrogate(BLUEProblem):
        """P_n(l) = mu_n + (chol(C_n) z)_l with shared z: per-output model
        covariance equals the loaded C_n, so the offline allocation is the
        right one for this model family."""

        def sample_input_jax(self, key):
            return jax.random.normal(key, (12,))

        def evaluate_model_jax(self, l, z):
            return jnp.stack([TRUE_MEANS[n] + jnp.asarray(Ls[n])[l] @ z
                              for n in range(6)])

    q = NSSurrogate(12, n_outputs=6, C=[np.asarray(c) for c in C],
                    costs=p.get_costs(), verbose=True,
                    skip_projection=True, device_batch_size=8192)
    # a wider tolerance keeps the demo fast; the allocation machinery is
    # identical to the paper run above
    eps_demo = 20 * eps
    mus, errs, cost = q.solve(K=K, eps=eps_demo)
    print("\nSurrogate estimation run (eps = 20x study tolerance):")
    ok = True
    for n in range(6):
        dev = abs(float(mus[n]) - TRUE_MEANS[n])
        print("  output %d: mu_hat=%9.5f (true %.1f)  |err|=%.2e  "
              "predicted rmse=%.2e" % (n, float(mus[n]), TRUE_MEANS[n],
                                       dev, errs[n]))
        ok &= dev < 5 * max(errs[n], 1e-12)
    print("estimates within 5x predicted RMSE:", bool(ok))
    assert ok


if __name__ == "__main__":
    main()
