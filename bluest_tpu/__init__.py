"""bluest_tpu: multilevel best linear unbiased estimation in JAX.

A ground-up JAX/XLA rebuild of the capabilities of croci/bluest: MLBLUE,
MLMC and MFMC estimators with on-device sample-allocation optimization
(JAX-native SDP interior point replacing cvxopt/cvxpy), vmapped + sharded
Monte Carlo sampling replacing MPI, and mask-based covariance semantics
replacing NaN/inf sentinel graphs.
"""

from . import config  # noqa: F401  (enables x64 before anything else)

from .sampling.host_engine import blue_fn
from .allocation import SAP, MOSAP, BLUESTError
from .problem import BLUEProblem

__version__ = "0.5.0"  # keep in sync with pyproject.toml
__all__ = ["blue_fn", "SAP", "MOSAP", "BLUESTError", "BLUEProblem",
           "__version__"]
