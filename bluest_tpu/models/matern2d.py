"""Multi-fidelity 2D Matern random field family (SPDE route).

Mirrors the reference's Matern restriction study
(examples/paper_examples/restrictions_matern/restrictions_matern.py):
the model hierarchy is the SPDE sampler of a Matern field,

    (kappa^2 - Laplace)^alpha  z = white noise,   z|_boundary = 0,

discretized with the Dirichlet sine basis on an n_l x n_l grid.  In that
basis the operator is diagonal, so a sample is one spectral scaling plus
two sine-synthesis matmuls:

    z = S_x ( W_hat * g(lambda) ) S_y^T,   g = (kappa^2 + lambda)^-alpha

Fidelities share the SAME white-noise coefficients on the finest spectral
grid; coarser models use the low-frequency block (spectral restriction --
the study's coupling mechanism).  QoIs (3 outputs): field energy
mean(z^2), center value z(1/2,1/2), and a smooth exceedance functional
mean(sigmoid(z - 1)).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..parallel.mesh import MODEL_AXIS
from ..problem import BLUEProblem


def _sine_basis(n: int, dtype) -> jnp.ndarray:
    """S[i, j] = sqrt(2) sin(pi (i+1/2)/n * (j+1)) evaluated on the cell
    centers of an n-point grid, modes j = 1..n."""
    x = (np.arange(n) + 0.5) / n
    j = np.arange(1, n + 1)
    return jnp.asarray(np.sqrt(2.0) * np.sin(np.pi * x[:, None] * j[None, :]),
                       dtype=dtype)


def sample_matern2d(w_hat, n: int, kappa: float = 8.0, alpha: float = 1.0):
    """One field sample on the n x n grid from finest-grid white noise
    coefficients w_hat (n0, n0); uses the top-left (low-frequency) n x n
    block.  Returns z (n, n)."""
    dt = w_hat.dtype
    wh = w_hat[:n, :n]
    j = jnp.arange(1, n + 1, dtype=dt)
    lam = (jnp.pi * j[:, None]) ** 2 + (jnp.pi * j[None, :]) ** 2
    g = (dt.type(kappa ** 2) + lam) ** dt.type(-alpha)
    # normalization keeps the field variance O(1) across kappa
    g = g * dt.type(kappa ** (2 * alpha - 1))
    S = _sine_basis(n, dt)
    return S @ (wh * g) @ S.T


def sample_matern2d_sharded(w_hat, n: int, n_shards: int,
                            kappa: float = 8.0, alpha: float = 1.0):
    """Model-parallel field synthesis: this shard synthesizes its block of
    x-modes and the full field is assembled with a psum over the 'model'
    mesh axis -- the JAX form of the reference's internally-MPI-
    parallel user models (blue_models.py:121-130, restrictions_matern.py:
    19-37).  Requires n divisible by n_shards."""
    dt = w_hat.dtype
    wh = w_hat[:n, :n]
    j = jnp.arange(1, n + 1, dtype=dt)
    lam = (jnp.pi * j[:, None]) ** 2 + (jnp.pi * j[None, :]) ** 2
    g = (dt.type(kappa ** 2) + lam) ** dt.type(-alpha)
    g = g * dt.type(kappa ** (2 * alpha - 1))
    S = _sine_basis(n, dt)
    m = jax.lax.axis_index(MODEL_AXIS)
    rows = n // n_shards
    zero = jnp.zeros((), m.dtype)
    blk = jax.lax.dynamic_slice(wh * g, (m * rows, zero), (rows, n))
    S_cols = jax.lax.dynamic_slice(S, (zero, m * rows), (n, rows))
    return jax.lax.psum(S_cols @ blk @ S.T, MODEL_AXIS)


def _qois(z, n):
    q_energy = jnp.mean(z * z)
    q_center = z[n // 2, n // 2]
    q_exceed = jnp.mean(jax.nn.sigmoid((z - 1.0) * 4.0))
    return jnp.stack([q_energy, q_center, q_exceed])


def matern2d_outputs(w_hat, n: int, kappa: float = 8.0, alpha: float = 1.0,
                     n_shards: int = 1):
    if n_shards > 1:
        z = sample_matern2d_sharded(w_hat, n, n_shards, kappa, alpha)
    else:
        z = sample_matern2d(w_hat, n, kappa, alpha)
    return _qois(z, n)


class Matern2DProblem(BLUEProblem):
    """Fidelity = grid resolution (spectral restriction coupling).

    Costs default to the synthesis matmul work, O(n^3), normalized to the
    coarsest model.  On a 2D (samples x model) mesh the production
    evaluation path itself spans the model axis: each device of a model
    instance synthesizes a block of spectral modes and the field is
    psum-assembled (sample_matern2d_sharded)."""

    def __init__(self, grids=(64, 32, 16, 8), kappa: float = 8.0,
                 alpha: float = 1.0, dtype=None, **params):
        self.grids = tuple(int(g) for g in grids)
        self.kappa = kappa
        self.alpha = alpha
        self.dtype = dtype
        params.setdefault("costs", np.array(
            [(g / grids[-1]) ** 3 for g in self.grids], dtype=float))
        params.setdefault("n_outputs", 3)
        # pilot sampling runs inside super().__init__, so the shard count
        # must be derived from the mesh parameter before it
        self._model_shards = 1
        mesh = params.get("mesh")
        if (hasattr(mesh, "axis_names") and MODEL_AXIS in mesh.axis_names
                and mesh.shape[MODEL_AXIS] > 1):
            self._model_shards = int(mesh.shape[MODEL_AXIS])
            if any(g % self._model_shards for g in self.grids):
                raise ValueError("grids must be divisible by the model-axis "
                                 "size for sharded synthesis")
        super().__init__(len(self.grids), **params)

    def sample_input_jax(self, key):
        dt = self.dtype or jnp.float64
        n0 = self.grids[0]
        return jax.random.normal(key, (n0, n0), dt)

    def evaluate_model_jax(self, l, w_hat):
        return matern2d_outputs(w_hat, self.grids[l], self.kappa,
                                self.alpha, n_shards=self._model_shards)
