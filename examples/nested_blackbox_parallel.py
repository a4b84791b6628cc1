"""Nested parallelism for internally-parallel black-box models.

The reference's headline pattern (README.md:26, demonstrated in
examples/paper_examples/restrictions_matern/restrictions_matern.py:19-37):
the user's model is itself parallel -- there, an MPI-parallel FEniCS
solver on a split communicator.  Here the same capability without MPI:

    params['host_workers']  = W   # W independent sample streams
    params['model_workers'] = G   # G processes cooperate per evaluation

The engine launches W groups of G processes; within a group every rank
runs the same sample stream and ``evaluate`` coordinates its ranks
through the MPI-like communicator returned by ``problem.get_comm()``
(rank/size/barrier/bcast/gather/allgather/allreduce).

The toy model below integrates a random field over a domain that is
decomposed across the group's ranks -- the structure of any
domain-decomposed PDE solver.

Run:  python examples/nested_blackbox_parallel.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from bluest_tpu import BLUEProblem

M = 3                      # fidelities = quadrature resolutions
CELLS = (256, 64, 16)      # cells per fidelity


class DomainDecomposedProblem(BLUEProblem):
    """Black-box model: output = integral of exp(sin(8x + z)) over [0,1],
    midpoint rule with CELLS[l] cells, cells partitioned across the
    model group's ranks."""

    def set_worker_id(self, wid):
        # one RNG per sample stream (= per group); MANDATORY for
        # host_workers > 1 -- all ranks of a group share the stream
        self._rng = np.random.default_rng(123 + wid)

    def sampler(self, ls, N=1):
        if not hasattr(self, "_rng"):
            self._rng = np.random.default_rng(0)
        z = float(self._rng.standard_normal())
        return [z for _ in ls]

    def evaluate(self, ls, samples, N=1):
        comm = self.get_comm()                 # None when serial
        rank = comm.rank if comm is not None else 0
        size = comm.size if comm is not None else 1
        out = []
        for i, l in enumerate(ls):
            n = CELLS[l]
            # this rank's slice of the domain
            cells = np.arange(rank, n, size)
            x = (cells + 0.5) / n
            partial = float(np.sum(np.exp(np.sin(8 * x + samples[i]))) / n)
            total = (comm.allreduce(partial) if comm is not None
                     else partial)
            out.append(total)
        return [out]


def main():
    costs = np.array([float(c) for c in CELLS])
    p = DomainDecomposedProblem(
        M, C=np.full((M, M), np.nan), costs=costs,
        covariance_estimation_samples=256,
        host_workers=2, model_workers=2, verbose=False)

    C = p.get_covariance()
    print("estimated covariance diagonal:", np.round(np.diag(C), 5))

    eps = 0.02 * np.sqrt(C[0, 0])
    p.setup_solver(K=2, eps=eps)
    mus, errs, cost = p.solve(K=2, eps=eps)
    print(f"estimate {mus[0]:.5f} +- {errs[0]:.5f}  (cost {cost:.0f})")

    # serial cross-check on the same seeds
    ps = DomainDecomposedProblem(
        M, C=np.full((M, M), np.nan), costs=costs,
        covariance_estimation_samples=256, verbose=False)
    Cs = ps.get_covariance()
    print("serial covariance diagonal:   ", np.round(np.diag(Cs), 5))


if __name__ == "__main__":
    main()
