"""Multi-fidelity 1D stochastic diffusion: the PDE flagship model family.

Plays the role of the reference's FEniCS PDE examples (the Matern
restriction study, restrictions_matern.py, and the mesh-hierarchy pattern
of bluest_NS.py): a lognormal-coefficient elliptic problem

    -(a(x, xi) u')' = 1  on (0, 1),  u(0) = u(1) = 0,
    log a = sum_k  xi_k * sigma * k^-nu * sqrt(2) sin(k pi x)

solved by finite differences on a hierarchy of grids (fidelity = grid
resolution), with the SAME random coefficients xi shared across
fidelities.  QoI = trapezoidal integral of u.

Everything is jax-native: the per-sample tridiagonal solve (cyclic
reduction on power-of-two grids, a Thomas ``lax.scan`` otherwise)
becomes batch-wide elementwise work under ``vmap`` -- one batched solve
per group evaluation, no host round trips.  On a CUDA GPU, f32 models
run the fused Triton kernel of ``ops/triton_diffusion.py`` instead (see
``DiffusionProblem.evaluate_model_jax_batched``).  This is the bench.py
workhorse for the 1e6-sample throughput target.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..problem import BLUEProblem


def cyclic_reduction_solve(lower, diag, upper, rhs):
    """Tridiagonal solve by cyclic reduction: log2(n) vectorized levels.

    Requires n = 2^p - 1 unknowns.  The Thomas recurrence is a 2n-step
    sequential scan whose per-step work is a handful of scalars; cyclic
    reduction does the same O(n) flops in ~2 log2 n wide sweeps and vmaps
    cleanly over the sample batch.  It was chosen on the previous
    accelerator; which form is faster on the H100 is not yet measured
    (ROADMAP A5).
    """
    a, b, c, d = lower, diag, upper, rhs
    levels = []
    while b.shape[-1] > 1:
        alpha = a[..., 1::2] / b[..., 0:-1:2]
        gamma = c[..., 1::2] / b[..., 2::2]
        levels.append((a, b, c, d))
        a, b, c, d = (-alpha * a[..., 0:-1:2],
                      b[..., 1::2] - alpha * c[..., 0:-1:2]
                      - gamma * a[..., 2::2],
                      -gamma * c[..., 2::2],
                      d[..., 1::2] - alpha * d[..., 0:-1:2]
                      - gamma * d[..., 2::2])
    x = d / b

    def interleave(xe, xo):
        """(..., q+1) evens and (..., q) odds -> (..., 2q+1).
        Stack/reshape instead of a strided scatter (.at[::2].set), which
        lowers to an XLA scatter."""
        q = xo.shape[-1]
        pair = jnp.stack([xe[..., :q], xo], axis=-1)
        pair = pair.reshape(pair.shape[:-2] + (2 * q,))
        return jnp.concatenate([pair, xe[..., q:]], axis=-1)

    for a0, b0, c0, d0 in reversed(levels):
        # x holds the odd-position solutions of this level; solve evens
        zpad = jnp.zeros(b0.shape[:-1] + (1,), dtype=x.dtype)
        xodd = jnp.concatenate([zpad, x, zpad], axis=-1)  # x_{i-1}, x_{i+1}
        xe = (d0[..., 0::2] - a0[..., 0::2] * xodd[..., :-1]
              - c0[..., 0::2] * xodd[..., 1:]) / b0[..., 0::2]
        x = interleave(xe, x)
    return x


def thomas_solve(lower, diag, upper, rhs):
    """Tridiagonal solve via the Thomas algorithm as a double scan.

    All args length n (lower[0], upper[-1] ignored).  Sequential in n;
    the models use :func:`cyclic_reduction_solve` whenever n = 2^p - 1,
    and this form for other sizes and as the oracle in tests.
    """
    n = diag.shape[0]

    def fwd(carry, t):
        cp_prev, dp_prev = carry
        a, b, c, d = t
        denom = b - a * cp_prev
        cp = c / denom
        dp = (d - a * dp_prev) / denom
        return (cp, dp), (cp, dp)

    (_, _), (cps, dps) = jax.lax.scan(
        fwd, (jnp.zeros(()), jnp.zeros(())),
        (lower, diag, upper, rhs))

    def bwd(x_next, t):
        cp, dp = t
        x = dp - cp * x_next
        return x, x

    _, xs = jax.lax.scan(bwd, jnp.zeros(()), (cps, dps), reverse=True)
    return xs


def solve_diffusion_outputs(xi, n_cells: int, sigma: float = 1.0,
                            nu: float = 1.5):
    """Three QoIs for one sample: (integral of u, u(1/2), energy int a u'^2).

    Multi-output analog of the reference's multi-QoI PDE examples
    (multi_output_example.py, bluest_NS.py with 6 outputs)."""
    u, a, h = _solve_field(xi, n_cells, sigma, nu)
    z1 = jnp.zeros(1, u.dtype)
    q_int = h * jnp.sum(u)
    uu = jnp.concatenate([z1, u, z1])
    q_mid = uu[n_cells // 2]
    du = jnp.diff(uu) / h
    q_energy = h * jnp.sum(a * du * du)
    return jnp.stack([q_int, q_mid, q_energy])


def solve_diffusion(xi, n_cells: int, sigma: float = 1.0, nu: float = 1.5):
    """QoI for one sample: xi (n_kl,) -> integral of u over (0,1)."""
    u, a, h = _solve_field(xi, n_cells, sigma, nu)
    return h * jnp.sum(u)


def _solve_field(xi, n_cells: int, sigma: float, nu: float):
    """Shared FD solve: returns (interior u, face coefficients a, h).

    Computes in xi's dtype: pass float32 inputs for the fast path.  The
    f32 QoI error against f64 is set by the lognormal coefficient's
    conditioning: at sigma=1, nu=0.6 the median relative error is ~1.5e-3
    at n=1024 and ~1e-5 at n=64 on the CPU backend (tests/
    test_chip_smoke.py); the estimator sums always accumulate in f64."""
    dt = xi.dtype
    n_kl = xi.shape[0]
    # coefficient at the n_cells+1 interior faces x_j = j*h, j=0..n_cells
    h = 1.0 / n_cells
    xf = (jnp.arange(n_cells, dtype=dt) + dt.type(0.5)) * dt.type(h)
    k = jnp.arange(1, n_kl + 1, dtype=dt)
    ck = (sigma * k ** (-nu) * np.sqrt(2.0)).astype(dt)
    modes = jnp.sin(jnp.pi * xf[:, None] * k[None, :]).astype(dt)
    # HIGHEST: an f32 matmul may otherwise run in TF32 on a GPU, which
    # put the f32 model outside its CPU error class (chip_smoke.py)
    log_a = jnp.matmul(modes, ck * xi, precision=jax.lax.Precision.HIGHEST)
    a = jnp.exp(log_a)                            # (n_cells,) face/mid values

    # interior unknowns u_1..u_{n-1}; flux form: -(a_{i+1/2}(u_{i+1}-u_i)
    #  - a_{i-1/2}(u_i - u_{i-1}))/h^2 = 1
    am = a[:-1]   # a_{i-1/2} for i=1..n-1
    ap = a[1:]    # a_{i+1/2}
    inv_h2 = dt.type(1.0 / h ** 2)
    diag = (am + ap) * inv_h2
    lower = jnp.concatenate([jnp.zeros(1, dt), -am[1:] * inv_h2])
    upper = jnp.concatenate([-ap[:-1] * inv_h2, jnp.zeros(1, dt)])
    rhs = jnp.ones(n_cells - 1, dt)
    m = n_cells - 1
    if m >= 1 and (m & (m + 1)) == 0:      # m = 2^p - 1: powers-of-two grid
        u = cyclic_reduction_solve(lower, diag, upper, rhs)
    else:
        u = thomas_solve(lower, diag, upper, rhs)
    return u, a, h


def solve_diffusion_outputs_batched(xis, n_cells: int, sigma: float = 1.0,
                                    nu: float = 1.5):
    """Batched three-QoI evaluation with a transposed (grid, batch) layout.

    Keeps the batch on the minor axis and the grid on the major axis so
    cyclic reduction's stride-2 level slicing is row selection rather than
    striding along the minor axis, and the mode synthesis is one
    (n x k)(k x B) matmul.  The engines use the vmapped per-sample form
    (or the Triton kernel); this batched entry point is for users who
    write batched models directly.  xis: (B, n_kl) -> (B, 3).
    """
    dt = xis.dtype
    B, n_kl = xis.shape
    h = 1.0 / n_cells
    xf = (jnp.arange(n_cells, dtype=dt) + dt.type(0.5)) * dt.type(h)
    k = jnp.arange(1, n_kl + 1, dtype=dt)
    ck = (sigma * k ** (-nu) * np.sqrt(2.0)).astype(dt)
    modes = jnp.sin(jnp.pi * xf[:, None] * k[None, :]).astype(dt)
    log_a = jnp.matmul(modes, ck[:, None] * xis.T,  # (n_cells, B)
                       precision=jax.lax.Precision.HIGHEST)
    a = jnp.exp(log_a)

    am, ap = a[:-1], a[1:]
    inv_h2 = dt.type(1.0 / h ** 2)
    zrow = jnp.zeros((1, B), dt)
    diag = (am + ap) * inv_h2
    lower = jnp.concatenate([zrow, -am[1:] * inv_h2], axis=0)
    upper = jnp.concatenate([-ap[:-1] * inv_h2, zrow], axis=0)
    rhs = jnp.ones((n_cells - 1, B), dt)

    m = n_cells - 1
    if m >= 1 and (m & (m + 1)) == 0:
        u = _cyclic_reduction_axis0(lower, diag, upper, rhs)
    else:
        u = jax.vmap(thomas_solve, in_axes=1, out_axes=1)(
            lower, diag, upper, rhs)

    q_int = dt.type(h) * jnp.sum(u, axis=0)
    uu = jnp.concatenate([zrow, u, zrow], axis=0)
    q_mid = uu[n_cells // 2]
    du = jnp.diff(uu, axis=0) * dt.type(1.0 / h)
    q_energy = dt.type(h) * jnp.sum(a * du * du, axis=0)
    return jnp.stack([q_int, q_mid, q_energy], axis=1)  # (B, 3)


def _cyclic_reduction_axis0(a, b, c, d):
    """Cyclic reduction along axis 0 of (n, B) systems (see
    cyclic_reduction_solve for the algorithm; this layout keeps the batch
    on the minor axis so level slicing is row selection)."""
    levels = []
    while b.shape[0] > 1:
        alpha = a[1::2] / b[0:-1:2]
        gamma = c[1::2] / b[2::2]
        levels.append((a, b, c, d))
        a, b, c, d = (-alpha * a[0:-1:2],
                      b[1::2] - alpha * c[0:-1:2] - gamma * a[2::2],
                      -gamma * c[2::2],
                      d[1::2] - alpha * d[0:-1:2] - gamma * d[2::2])
    x = d / b

    for a0, b0, c0, d0 in reversed(levels):
        zrow = jnp.zeros((1,) + x.shape[1:], x.dtype)
        xodd = jnp.concatenate([zrow, x, zrow], axis=0)
        xe = (d0[0::2] - a0[0::2] * xodd[:-1] - c0[0::2] * xodd[1:]) \
            / b0[0::2]
        q = x.shape[0]
        pair = jnp.stack([xe[:q], x], axis=1)            # (q, 2, B)
        pair = pair.reshape((2 * q,) + x.shape[1:])
        x = jnp.concatenate([pair, xe[q:]], axis=0)
    return x


class DiffusionProblem(BLUEProblem):
    """Fidelity hierarchy over grid resolutions.

    Parameters: ``grids`` (cells per fidelity, finest first), ``n_kl``
    Karhunen-Loeve-style modes, field amplitude ``sigma`` and decay ``nu``.
    Costs default to the FD solve's O(n) work.  f32 models run the fused
    Triton kernel (``ops/triton_diffusion.py``) wherever the sweep is
    compiled for a CUDA GPU, and the plain XLA path elsewhere; f64 models
    take the plain path.
    """

    def __init__(self, grids=(256, 128, 64, 32, 16), n_kl: int = 16,
                 sigma: float = 0.5, nu: float = 1.5,
                 multi_output: bool = False, truncate_kl: bool = True,
                 dtype=None, **params):
        self.grids = tuple(int(g) for g in grids)
        self.dtype = dtype  # None -> f64; jnp.float32 for the fast path
        self.n_kl = n_kl
        self.sigma = sigma
        self.nu = nu
        self.multi_output = multi_output
        # coarse fidelities resolve only the field modes their grid can
        # represent (the classic multilevel setup: fidelity = grid AND
        # input dimension truncation) -- without this, smooth QoIs make
        # all fine models correlate to ~1-1e-7 and the hierarchy is
        # degenerate as a benchmark
        if truncate_kl:
            self.n_modes = tuple(min(self.n_kl, max(1, g // 4))
                                 for g in self.grids)
        else:
            self.n_modes = tuple(self.n_kl for _ in self.grids)
        params.setdefault("costs", np.array([g / grids[-1]
                                             for g in self.grids]))
        if multi_output:
            params.setdefault("n_outputs", 3)
        super().__init__(len(self.grids), **params)

    def sample_input_jax(self, key):
        dt = self.dtype or jnp.float64
        return jax.random.normal(key, (self.n_kl,), dt)  # shared across group

    def evaluate_model_jax(self, l, xi):
        import jax.numpy as _jnp
        mask = (_jnp.arange(self.n_kl) < self.n_modes[l])
        xi = xi * mask
        if self.multi_output:
            return solve_diffusion_outputs(xi, self.grids[l], self.sigma,
                                           self.nu)
        return solve_diffusion(xi, self.grids[l], self.sigma,
                               self.nu)[None]

    def evaluate_model_jax_batched(self, l, xis):
        """(B, n_kl) -> (B, n_outputs): the engine's batched model path.
        The choice between the Triton kernel and the vmapped plain path
        is made when the sweep is lowered, for the platform it is
        lowered for (so the same problem also runs on the host CPU)."""
        def plain(x):
            return jax.vmap(lambda t: self.evaluate_model_jax(l, t))(x)

        if xis.dtype != jnp.float32:
            return plain(xis)
        from ..ops.triton_diffusion import diffusion_outputs_triton

        def fused(x):
            q = diffusion_outputs_triton(x, self.grids[l], self.sigma,
                                         self.nu, self.n_modes[l])
            return q if self.multi_output else q[:, :1]

        return jax.lax.platform_dependent(xis, cuda=fused, default=plain)
