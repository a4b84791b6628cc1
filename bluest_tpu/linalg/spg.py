"""Nonmonotone spectral projected gradient, fully on device.

A fresh JAX implementation of the Birgin/Martinez/Raydan SPG method used by
the reference for masked SPD covariance projection (spg.py:39-132):
Barzilai-Borwein step, Grippo-style nonmonotone line search with quadratic
interpolation backtracking.  The whole solve is one ``lax.while_loop`` so it
jits and runs on the device without host round trips; the nonmonotone history is a
fixed-size ring buffer.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


class SPGResult(NamedTuple):
    x: jnp.ndarray
    f: jnp.ndarray
    gpmax: jnp.ndarray
    it: jnp.ndarray
    count: jnp.ndarray
    solver_info: jnp.ndarray  # 0 converged, 1 maxit, 2 max feval


_SIGMA_MIN = 0.1
_SIGMA_MAX = 0.9
_GAMMA = 1.0e-4


def spg(feval: Callable, geval: Callable, proj: Callable, x0,
        eps: float = 1.0e-4, maxit: int = 200, max_fevals: int = 10 ** 5,
        lmbda_min: float = 1e-30, lmbda_max: float = 1e30,
        history: int = 10) -> SPGResult:
    """Minimize ``feval`` over the convex set defined by projector ``proj``.

    All three callables must be jax-traceable on arrays shaped like ``x0``.
    Matches reference spg.py semantics: stops when the projected gradient
    sup-norm <= eps, or on iteration/feval budgets.
    """
    x0 = jnp.asarray(x0)

    def linesearch(x, f, g, d, fmax, count):
        gdotd = g @ d

        def cond(st):
            alpha, fnew, xnew, cnt = st
            return (fnew > fmax + _GAMMA * alpha * gdotd) & (cnt < max_fevals)

        def body(st):
            alpha, fnew, xnew, cnt = st
            alpha_t = -0.5 * (alpha ** 2) * gdotd / (fnew - f - alpha * gdotd)
            bad = (alpha_t < _SIGMA_MIN) | (alpha_t > _SIGMA_MAX * alpha)
            alpha_t = jnp.where(bad, 0.5 * alpha, alpha_t)
            alpha = jnp.where(alpha <= _SIGMA_MIN, 0.5 * alpha, alpha_t)
            xnew = x + alpha * d
            return alpha, feval(xnew), xnew, cnt + 1

        alpha0 = jnp.asarray(1.0, x0.dtype)
        xnew0 = x + alpha0 * d
        st = (alpha0, feval(xnew0), xnew0, count + 1)
        alpha, fnew, xnew, count = jax.lax.while_loop(cond, body, st)
        ok = fnew <= fmax + _GAMMA * alpha * gdotd
        return count, fnew, xnew, ok

    def outer_cond(st):
        x, f, g, gpmax, lmbda, hist, it, count, failed = st
        return (gpmax > eps) & (it < maxit) & (count < max_fevals) & (~failed)

    def outer_body(st):
        x, f, g, gpmax, lmbda, hist, it, count, failed = st
        d = proj(x - lmbda * g) - x
        fmax = jnp.max(hist)
        count, fnew, xnew, ok = linesearch(x, f, g, d, fmax, count)

        gnew = geval(xnew)
        s = xnew - x
        y = gnew - g
        sdots = s @ s
        sdoty = s @ y
        lmbda_new = jnp.where(sdoty <= 0, lmbda_max,
                              jnp.clip(sdots / sdoty, lmbda_min, lmbda_max))
        it_new = it + 1
        hist_new = hist.at[it_new % history].set(fnew)
        gp = proj(xnew - gnew) - xnew
        gpmax_new = jnp.max(jnp.abs(gp))

        # on line-search failure keep the old iterate and flag termination
        x_out = jnp.where(ok, xnew, x)
        f_out = jnp.where(ok, fnew, f)
        g_out = jnp.where(ok, gnew, g)
        gpmax_out = jnp.where(ok, gpmax_new, gpmax)
        return (x_out, f_out, g_out, gpmax_out,
                jnp.where(ok, lmbda_new, lmbda),
                jnp.where(ok, hist_new, hist),
                jnp.where(ok, it_new, it), count, ~ok)

    x = proj(x0)
    f = feval(x)
    g = geval(x)
    gp = proj(x - g) - x
    gpmax = jnp.max(jnp.abs(gp))
    lmbda = jnp.where(gpmax > 1e-15,
                      jnp.clip(1.0 / jnp.maximum(gpmax, 1e-300), lmbda_min, lmbda_max),
                      0.0)
    hist = jnp.full((history,), -jnp.inf, dtype=x.dtype).at[0].set(f)

    st = (x, f, g, gpmax, lmbda, hist,
          jnp.asarray(0), jnp.asarray(1), jnp.asarray(False))
    x, f, g, gpmax, lmbda, hist, it, count, failed = jax.lax.while_loop(
        outer_cond, outer_body, st)

    info = jnp.where(gpmax <= eps, 0,
                     jnp.where(failed | (count >= max_fevals), 2, 1))
    return SPGResult(x=x, f=f, gpmax=gpmax, it=it, count=count, solver_info=info)
