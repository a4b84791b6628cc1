"""Fused diffusion-model kernel for NVIDIA GPUs (Pallas through Triton).

Evaluates the three QoIs of :func:`models.diffusion.solve_diffusion_outputs`
for a block of samples per program, one sample per lane: the KL synthesis
of the log coefficient, the Thomas forward sweep, and the back
substitution with the three QoIs fused into it.  The forward sweep's
coefficients and cp/dp go to global scratch outputs, which L2 mostly
holds; nothing of the (n, B) system is materialized by XLA.

On an H100 at the bench batch (8192 samples) it takes about half the
device time of XLA's cyclic-reduction path at n=1024, and the bench solve
about 0.92x its wall (PERF.md).  ``DiffusionProblem`` uses it for f32
models wherever the sweep is compiled for a CUDA GPU; the CPU tests run
it with ``interpret=True``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton


def _kernel(xi_ref, m_ref, q_ref, a_ref, cp_ref, dp_ref, *, n, h, barrier):
    """One block of samples (lanes).  xi_ref (K, BS): inputs, transposed;
    m_ref (K, N): modes scaled by their amplitudes, faces 0..n-1 in the
    first n columns; q_ref (4, BS): the QoIs in rows 0-2; a_ref, cp_ref,
    dp_ref (N, BS): scratch outputs, rows 0..n-1 used (N = n rounded up
    to a power of two, as Triton's block shapes require)."""
    xi = xi_ref[...]

    def coef(j):                                   # a at face j, (1, BS)
        col = m_ref[:, pl.ds(j, 1)]
        return jnp.exp(jnp.sum(col * xi, axis=0, keepdims=True))

    m = n - 1
    h2 = h * h
    a0 = coef(0)
    a_ref[pl.ds(0, 1), :] = a0
    zero = jnp.zeros_like(a0)

    # Thomas forward sweep of the system scaled by h^2: row r has
    # lower -a_r, diagonal a_r + a_{r+1}, upper -a_{r+1}, rhs h^2
    def fwd(r, carry):
        am, cp, dp = carry
        ap = coef(r + 1)
        a_ref[pl.ds(r + 1, 1), :] = ap
        denom = am + ap + am * cp
        cp = -ap / denom
        dp = (h2 + am * dp) / denom
        cp_ref[pl.ds(r, 1), :] = cp
        dp_ref[pl.ds(r, 1), :] = dp
        return ap, cp, dp

    jax.lax.fori_loop(0, m, fwd, (a0, zero, zero))
    if barrier:
        pltriton.debug_barrier()

    # back substitution; u_r = x_r, u at both walls is 0
    def bwd(i, carry):
        r = m - 1 - i
        x_next, s, e, mid = carry
        x = dp_ref[pl.ds(r, 1), :] - cp_ref[pl.ds(r, 1), :] * x_next
        d = x_next - x
        e = e + a_ref[pl.ds(r + 1, 1), :] * d * d
        mid = jnp.where(r == n // 2 - 1, x, mid)
        return x, s + x, e, mid

    x0, s, e, mid = jax.lax.fori_loop(0, m, bwd, (zero, zero, zero, zero))
    e = e + a0 * x0 * x0
    q_ref[pl.ds(0, 1), :] = h * s
    q_ref[pl.ds(1, 1), :] = mid
    q_ref[pl.ds(2, 1), :] = e / h


# 64 lanes in 2 warps per program: at B = 8192 that is 128 programs,
# about one per SM of an H100 (the first translation's sweep over 32,
# 64 and 128 lanes put 64 first at n=1024 and 256, PERF.md)
BLOCK = 64
NUM_WARPS = 2


def _pow2(x):
    return 1 << max(0, int(x - 1).bit_length())


def diffusion_outputs_triton(xis, n_cells, sigma, nu, n_modes=None,
                             block=BLOCK, interpret=False):
    """(B, n_kl) inputs -> (B, 3) QoIs of ``solve_diffusion_outputs`` on
    grid ``n_cells``, with inputs past ``n_modes`` masked to zero.  Runs
    the kernel compiled for a GPU, or with JAX's Pallas interpreter on any
    backend when ``interpret`` is set."""
    n = int(n_cells)
    if n < 2:
        raise ValueError("the grid needs at least 2 cells, got %d" % n)
    B, K = xis.shape
    dt = xis.dtype
    if n_modes is not None:
        xis = xis * (jnp.arange(K) < n_modes)
    h = 1.0 / n
    xf = (jnp.arange(n, dtype=dt) + dt.type(0.5)) * dt.type(h)
    k = jnp.arange(1, K + 1, dtype=dt)
    ck = (sigma * k ** (-nu) * np.sqrt(2.0)).astype(dt)
    modes = ck[:, None] * jnp.sin(jnp.pi * k[:, None] * xf[None, :])
    Kp, N, Bp = _pow2(K), _pow2(n), -(-B // block) * block
    xt = jnp.zeros((Kp, Bp), dt).at[:K, :B].set(xis.T)
    modes = jnp.zeros((Kp, N), dt).at[:K, :n].set(modes)

    kernel = functools.partial(_kernel, n=n, h=h, barrier=not interpret)
    scratch = jax.ShapeDtypeStruct((N, Bp), dt)
    col = lambda i: (0, i)
    q, _, _, _ = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((4, Bp), dt), scratch, scratch,
                   scratch),
        grid=(Bp // block,),
        in_specs=[pl.BlockSpec((Kp, block), col),
                  pl.BlockSpec((Kp, N), lambda i: (0, 0))],
        out_specs=(pl.BlockSpec((4, block), col),
                   pl.BlockSpec((N, block), col),
                   pl.BlockSpec((N, block), col),
                   pl.BlockSpec((N, block), col)),
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        backend="triton", interpret=interpret,
        name="diffusion_thomas_%d" % n,
    )(xt, modes)
    return q[:3, :B].T
