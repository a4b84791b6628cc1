"""JAX-native homogeneous self-dual interior-point solver for cone
programs with a nonnegative-orthant block and dense PSD blocks.

Replaces cvxopt ``solvers.sdp`` (the reference's default allocation solver,
sap.py:242-307, mosap.py:395-463) with an on-device implementation.  Solves
the inequality-form cone program

    minimize    c^T x
    subject to  Gl x <= hl                           (componentwise)
                sum_i x_i * As[b, i]  <=  Hs[b]      (PSD order, per block b)

via the homogeneous self-dual (HSD) embedding of Ye-Todd-Mizuno with
Nesterov-Todd scaling and a Mehrotra predictor-corrector:

    G^T z + c tau            = 0          (dual)
    h tau - G x - s          = 0          (primal;  s in K)
    -c^T x - h^T z - kappa   = 0          (gap;     z in K, tau,kappa > 0)

A solution with tau > 0 recovers (x,s,z)/tau as a primal-dual optimal
pair; tau -> 0 with kappa > 0 certifies infeasibility.  The embedding is
what makes degenerate MLBLUE instances (complete group sets, rho -> 1,
heterogeneous eps) solvable without fallback heuristics: the iterate
stays bounded on the central path instead of wandering to the extreme
magnitudes that stall a plain infeasible-start method (and, on CPU,
drop it into subnormal arithmetic).

Design notes:

* MLBLUE allocation SDPs are small (x-dim <= ~400, PSD blocks of size
  M+1 <= ~20, one per output and all the same size), so PSD blocks are kept
  as one stacked (nb, n, n) array and every cone operation is vmapped.
* NT scaling for a PSD block only needs the metric geometric mean
  T = S^1/2 (S^1/2 Z S^1/2)^-1/2 S^1/2  (T Z T = S): the Newton system
  reduces to normal equations with the SAME matrix as the non-embedded
  method,  Hmat = Gl^T diag(z/s) Gl + sum_b tr(A_i T^-1 A_k T^-1),
  plus a rank-one tau border handled by a 2-solve Schur complement:
      Hmat v1 = c - q,   Hmat v2 = rx,      q = G^T (W^T W)^{-1} h
      dtau = (rt + (c+q)@v2) / ((c+q)@v1 + h'(W^TW)^{-1}h + kappa/tau)
      dx = v2 - dtau * v1
  The denominator is c'H^{-1}c + Schur(h) + kappa/tau > 0.
* Every solve is Cholesky or eigh based (no LU; a rule from the previous
  accelerator, whose f64 had no LU kernel -- not yet revisited for the
  H100, ROADMAP C7).
* **The entire solve is ONE jitted program**: initialization, the
  predictor-corrector iteration, and the stall / best-iterate /
  convergence bookkeeping all live inside a single ``lax.while_loop``,
  so a solve costs O(1) dispatches (a host-driven loop costs ~6
  dispatches + 4 device->host syncs per iteration).
"""

from __future__ import annotations

import hashlib
import os
import threading
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .ipm_worker import IPMWorkerInfraError

__all__ = ["ConeLPResult", "solve_cone_lp"]


class ConeLPResult(NamedTuple):
    x: np.ndarray
    status: str          # "optimal" | "inaccurate" | "max_iter" |
                         # "failed" | "infeasible" | "unbounded"
    iterations: int
    gap: float
    pres: float
    dres: float
    pobj: float
    dims: Optional[dict] = None   # {nx, p, nb, n, rank, woodbury, wall_s}:
                                  # problem shape + solve wall for flops
                                  # accounting (bench MFU lines)


def ipm_iteration_flops(dims: dict) -> float:
    """Estimated f64 flops of ONE IPM iteration from the problem dims
    recorded in ``ConeLPResult.dims`` (documented model, ~2x accuracy --
    for achieved-FLOP/s reporting, not for exact op counts).

    Per iteration the solver refactors the normal matrix once and runs
    ~4 solves against it (predictor, corrector, tau border, centering
    fallback), plus batched NT scaling algebra on the (nb, n, n) PSD
    blocks (cholesky x2, SVD, eigh line searches ~ 20 n^3 each).

    Woodbury path (``_wood_factor``/``_wood_apply``): capacitance build
    ``W^T (W/d0)`` = 2 nx r^2, Cholesky r^3/3, and each solve pays
    (1 + _WOOD_REFINE) refinement rounds of one implicit solve + one
    matvec ~ 8 nx r each.

    Dense path (``_chol_factor``): Hmat formation 2 nb nx^2 n^2
    (the ``einsum`` over coefficient slabs) + nx^3/3 factorization +
    solves ~ 4 x 2 nx^2.
    """
    nx = float(dims["nx"])
    nb = float(dims["nb"])
    n = float(dims["n"])
    r = float(dims.get("rank", 0))
    nt = nb * 20.0 * n ** 3
    if dims.get("woodbury"):
        n_ref = 1.0 + _WOOD_REFINE
        return (2.0 * nx * r * r + r ** 3 / 3.0
                + 4.0 * n_ref * 8.0 * nx * r + nt)
    return 2.0 * nb * nx * nx * n * n + nx ** 3 / 3.0 + 8.0 * nx * nx + nt


def _sym(A):
    return (A + jnp.swapaxes(A, -1, -2)) / 2


def _chol_factor(H, jitter=1e-14):
    """Equilibrated Cholesky factor of an SPD matrix.

    The IPM normal matrix mixes (W^T W)^{-1} scales spanning ~1/mu^2, so a
    trace-proportional ridge would wipe out the small-curvature directions
    (exactly the active-constraint information).  Equilibrating to unit
    diagonal first makes a ~1e-14 ridge scale-invariant and harmless.

    Factored once and reused across every solve against the same matrix --
    at L ~ 3000 group variables the O(L^3) factorization dominates an IPM
    iteration, and one iteration needs solves against the same Hmat for
    the predictor, corrector, centering fallback, and tau border.
    """
    n = H.shape[0]
    d = jnp.sqrt(jnp.clip(jnp.diag(H), 1e-150, None))
    Hs = H / d[:, None] / d[None, :]
    L = jnp.linalg.cholesky(Hs + jitter * jnp.eye(n, dtype=H.dtype))
    return H, L, d


def _chol_apply(fac, RHS):
    """Solve with a _chol_factor result (+ one refinement step)."""
    H, L, d = fac
    one_d = RHS.ndim == 1
    B = RHS[:, None] if one_d else RHS

    def solve(b):
        bs = b / d[:, None]
        y = jax.scipy.linalg.solve_triangular(L, bs, lower=True)
        return jax.scipy.linalg.solve_triangular(L.T, y, lower=False) / d[:, None]

    X = solve(B)
    X = X + solve(B - H @ X)  # one step of iterative refinement
    return X[:, 0] if one_d else X


# ------------------- diagonal + low-rank (Woodbury) ----------------------- #

def _psd_lowrank_factor(Ms):
    """Low-rank factor of the PSD-block Gram:  (nb, nx, n, n) symmetric
    slabs -> W of shape (nx, nb*n(n+1)/2) with
    (W W^T)[i,k] = sum_b <Ms[b,i], Ms[b,k]>_F  (symmetric vectorization,
    off-diagonals weighted by sqrt(2))."""
    nb, nx, n, _ = Ms.shape
    iu0, iu1 = np.triu_indices(n)
    wts = jnp.asarray(np.where(iu0 == iu1, 1.0, np.sqrt(2.0)), Ms.dtype)
    V = Ms[:, :, iu0, iu1] * wts                   # (nb, nx, ns)
    return jnp.transpose(V, (1, 0, 2)).reshape(nx, nb * iu0.shape[0])


def _wood_factor(d0, W, jitter=1e-14):
    """Factor  H = diag(d0) + W W^T  via the capacitance matrix
    C = I + W^T diag(1/d0) W  (equilibrated Cholesky, like _chol_factor).

    This is the large-L fast path of the IPM: the MLBLUE normal matrix is
    diag + rank-(p_R + nb*n(n+1)/2), so factoring costs O(nx r^2 + r^3)
    instead of the dense O(nx^3) -- at L ~ 3300 group variables and
    r ~ 530 that is the difference between ~2 s and ~0.1 s per iteration.

    Numerical note: d0 = (z/s) gl^2 spans ~mu..1/mu late in the solve, so
    the Woodbury recovery x = D^{-1}b - D^{-1}W C^{-1} W^T D^{-1} b
    cancels up to ~12 digits on coordinates where a tiny d0 meets an O(1)
    low-rank column.  _wood_apply therefore runs FOUR steps of iterative
    refinement against the exact implicit matvec (each O(nx r), ~free):
    measured on an L=1585 HH-like instance, 2 steps stall the endgame at
    gap 4e-8 ('inaccurate') while 4 match the dense path's iteration
    count and 'optimal' exit; the equilibrated capacitance Cholesky
    handles the scale spread the same way the dense path's equilibration
    does.  Controlled A/B on the K=6 HH golden (L=2509,
    tools/ab_profile.py): WOOD_REFINE=2 does not terminate within 40
    minutes -- the inaccurate exit cascades into the cross-check and NLP
    fallback chain -- so the 4-step default is a robustness requirement,
    not a tuning preference."""
    r = W.shape[1]
    if _WOOD_PAD > 0:
        # zero-column padding to an aligned rank: the capacitance GEMM
        # (r, nx)@(nx, r) is the per-iteration hot spot and odd r can
        # land it in a slow shape regime on some backends; zero columns
        # append an identity block to C, so the factorization and every
        # _wood_apply are EXACTLY unchanged mathematically
        r_pad = _WOOD_PAD * -(-r // _WOOD_PAD)
        if r_pad != r:
            W = jnp.pad(W, ((0, 0), (0, r_pad - r)))
            r = r_pad
    Wd = W / d0[:, None]
    # mixed-precision experiment (VERDICT r4 item 5): the capacitance
    # GEMM and the apply-path matvecs are the per-iteration flops; with
    # BLUEST_TPU_IPM_GEMM_DTYPE=f32 they run in f32 while the Cholesky,
    # the refinement
    # matvec and every residual stay f64 -- classic mixed-precision
    # iterative refinement, the existing _WOOD_REFINE loop is the
    # accuracy anchor.  The GEMM uses the SYMMETRIC split V = D^{-1/2} W
    # (C = I + V^T V), which halves the exponent range f32 must absorb
    # (d0 spans ~mu..1/mu late in the solve).  Default f64 = the
    # long-validated path, bit-exact (V^T V == W^T Wd analytically; the
    # f64 path keeps the historical W^T Wd product).
    if _GEMM_DTYPE_NAME == "f64":
        C = jnp.eye(r, dtype=W.dtype) + W.T @ Wd
        Vg = None
    else:
        V = W / jnp.sqrt(d0)[:, None]
        Vg = _gemm_cast(V)
        C = jnp.eye(r, dtype=W.dtype) + (Vg.T @ Vg).astype(W.dtype)
    return d0, W, Wd, _chol_factor(C, jitter=jitter), Vg


_WOOD_REFINE = int(os.environ.get("BLUEST_TPU_WOOD_REFINE", "4"))
# Mixed-precision GEMM dtype for the Woodbury capacitance/apply path
# ("f64" default = bit-exact historical behavior; "f32" runs the hot
# GEMMs in f32 with f64 iterative refinement -- the on-chip allocation
# experiment of VERDICT r4 item 5).
_GEMM_DTYPE_NAME = os.environ.get("BLUEST_TPU_IPM_GEMM_DTYPE", "f64")


def _gemm_cast(x):
    if _GEMM_DTYPE_NAME == "f32":
        return x.astype(jnp.float32)
    if _GEMM_DTYPE_NAME == "bf16":
        return x.astype(jnp.bfloat16)
    return x
# Zero-pad the Woodbury low-rank factor to a multiple of this (0 = off);
# purely a GEMM-shape experiment knob, mathematically a no-op.  Measured
# on the K=7 HH golden (L=3301, r 531 -> 640, tools/ab_profile.py, 3 ABBA
# blocks): a LOSS -- per-iteration B/A median 1.43 ([0.87, 1.78, 1.43]),
# identical cost, zero fallbacks.  The capacitance GEMM is not
# shape-alignment-bound on this host backend; keep 0 here.
_WOOD_PAD = int(os.environ.get("BLUEST_TPU_WOOD_PAD", "0"))
# Gondzio centrality correctors per iteration (LP + tau/kappa blocks).
# Default OFF: measured on the K=7 HH golden (L=3301), one corrector cuts
# iterations 64 -> 55 and tightens dres 1.6e-5 -> 4.1e-8, but the extra
# per-iteration hsolve + cone line search (batched small eigh -- a bad
# shape regime for this host backend) makes wall time a wash (37.4s vs
# ~34s); two correctors are strictly worse (59 its, ~2x/iter cost).
# Confirmed under the Woodbury path by controlled ABBA A/B on the K=6
# golden (L=2509, tools/ab_profile.py): its 60 -> 55 deterministic, but
# per-iteration wall B/A [1.07, 1.26] -- the corrector's extra hsolve +
# line search still eats the iteration cut.  Round-4 ABBA at the BENCH
# shape (K=4 diffusion budget ray, L=385, Woodbury r=201): the
# corrector cuts ZERO iterations (34 -> 34; its acceptance test never
# fires on this well-centered path) and costs wall B/A
# [1.158, 1.158, 1.12].  Kept behind the env knob for hardware where
# small batched eigh is fast.
_GONDZIO = int(os.environ.get("BLUEST_TPU_GONDZIO", "0"))


def _wood_apply(fac, RHS):
    d0, W, Wd, Cfac, Vg = fac
    one_d = RHS.ndim == 1
    B = RHS[:, None] if one_d else RHS
    f64 = W.dtype
    sq = None if Vg is None else jnp.sqrt(d0)[:, None]

    def solve(b):
        if Vg is None:              # f64 path: historical, bit-exact
            t = b / d0[:, None]
            return t - Wd @ _chol_apply(Cfac, W.T @ t)
        # mixed-precision approximate solve via the symmetric split
        # x = D^{-1/2}(bh - V C^{-1} V^T bh), bh = D^{-1/2} b: the V
        # matvecs run in the GEMM dtype; the refinement below corrects
        # against the EXACT f64 matvec
        bh = b / sq
        u = (Vg.T @ _gemm_cast(bh)).astype(f64)
        y = _chol_apply(Cfac, u)
        return (bh - (Vg @ _gemm_cast(y)).astype(f64)) / sq

    def matvec(x):
        # exact residual matvec: always f64 (the accuracy anchor)
        return d0[:, None] * x + W @ (W.T @ x)

    X = solve(B)
    for _ in range(_WOOD_REFINE):
        X = X + solve(B - matvec(X))
    return X[:, 0] if one_d else X


# --------------------- batched PSD cone primitives ----------------------- #

def _nt_scaling(S, Z):
    """Batched NT scaling via the Todd-Toh-Tutuncu recipe.

    With L_s = chol(S), L_z = chol(Z) and SVD L_s^T L_z = U Sig V^T, the
    factor R = L_s U Sig^{-1/2} satisfies R^T Z R = R^{-1} S R^{-T} = Sig
    (the diagonal scaled point lambda).  Returns (Tinv, R, Rinv, lam) with
    T = R R^T the metric geometric mean (T Z T = S).
    """
    Ls = jnp.linalg.cholesky(S)
    Lz = jnp.linalg.cholesky(Z)
    M = jnp.swapaxes(Ls, -1, -2) @ Lz
    U, sig, Vt = jnp.linalg.svd(M)
    sig = jnp.maximum(sig, 1e-150)
    R = (Ls @ U) / jnp.sqrt(sig)[:, None, :]
    # R^{-1} = Sig^{1/2} U^T L_s^{-1}: compute U^T L_s^{-1} as (L_s^{-T} U)^T
    LsTinvU = jax.vmap(lambda l, u: jax.scipy.linalg.solve_triangular(
        l.T, u, lower=False))(Ls, U)
    Rinv = jnp.sqrt(sig)[:, :, None] * jnp.swapaxes(LsTinvU, -1, -2)
    Tinv = jnp.swapaxes(Rinv, -1, -2) @ Rinv
    return _sym(Tinv), R, Rinv, sig


def _max_step_psd(S, dS):
    """Batched sup {a : S + a dS >= 0} (min over blocks)."""
    L = jnp.linalg.cholesky(S)
    M1 = jax.vmap(lambda l, d: jax.scipy.linalg.solve_triangular(l, d, lower=True))(L, dS)
    M2 = jax.vmap(lambda l, m: jax.scipy.linalg.solve_triangular(l, m.T, lower=True))(L, M1)
    lam_min = jnp.min(jnp.linalg.eigvalsh(_sym(M2))[:, 0])
    return jnp.where(lam_min >= 0, jnp.inf, -1.0 / jnp.minimum(lam_min, -1e-150))


def _max_step_lp(s, ds):
    ratio = jnp.where(ds < 0, -s / jnp.where(ds < 0, ds, -1.0), jnp.inf)
    return jnp.min(ratio) if s.shape[0] else jnp.asarray(jnp.inf)


def _max_step_scalar(t, dt):
    return jnp.where(dt < 0, -t / jnp.where(dt < 0, dt, -1.0), jnp.inf)


def _dual_polish(GT, Gall_mul, gsolve, p, nb, n, cj, z_lp, Z, tau, gate):
    """Minimum-norm dual correction restoring G^T z + c tau = 0,
    cone-limited so z stays strictly interior.  Shared by the gated
    in-loop polish and the unconditional final one -- one implementation
    so the two sites cannot silently diverge.  ``gate`` maps the dual
    residual to the initial step fraction (0.0 or 1.0)."""
    rd = cj * tau + GT(z_lp, Z)
    delta = -Gall_mul(gsolve(rd))
    beta = gate(rd)
    if p:
        beta = jnp.minimum(beta, 0.99 * _max_step_lp(z_lp, delta[:p]))
    if nb:
        dZc = _sym(delta[p:].reshape(nb, n, n))
        beta = jnp.minimum(beta, 0.99 * _max_step_psd(Z, dZc))
    beta = jnp.maximum(beta, 0.0)
    z_lp = z_lp + beta * delta[:p]
    if nb:
        Z = _sym(Z + beta * dZc)
    return z_lp, Z


# ---------------------- one HSD predictor-corrector step ------------------ #

def _iteration_core(cj, Glj, hlj, Aj, Hj, g_ops, gsolve, cnorm, step_frac,
                    gl_diag, Rj, woodbury, x, s_lp, S, z_lp, Z, tau, kappa):
    """One NT-scaled Mehrotra step on the HSD embedding.  Traced inside the
    fused while_loop; ``p``/``nb``/``woodbury`` branches are Python-static.

    ``gl_diag``/``Rj``: when the caller detects Gl = [diag(gl_diag); R]
    (the MLBLUE form: m >= 0 rows plus a handful of budget/coverage/cap
    rows), the LP block of the normal matrix is assembled as
    diag(d * gl_diag^2) + R^T diag(d_R) R instead of the dense
    O(nx^2 p) product -- the difference between 9 s and ~2 s per
    iteration at L ~ 3300 group variables.  ``gl_diag`` has size 0 when
    the structure does not apply.

    ``woodbury`` (static): never materialize the nx x nx normal matrix at
    all.  Its PSD contribution tr(A_i T^-1 A_k T^-1) is the Gram of
    svec(Rinv A_i Rinv^T) (rank nb*n(n+1)/2 per the NT factor Rinv with
    T^-1 = Rinv^T Rinv), so Hmat = diag(d0) + W W^T with
    W = [R^T sqrt(d_R) | svec factors] and all solves go through the
    r x r capacitance (_wood_factor).  ``gsolve`` solves against the
    Gram matrix G^T G for the dual polish (dense Cholesky or the same
    Woodbury structure, chosen by the caller)."""
    p = hlj.shape[0]
    nb, nx, n, _ = Aj.shape
    nu = p + nb * n + 1
    # structured/dense G applications, built ONCE in _ipm_solve so the
    # per-iteration operators can never desynchronize from the init /
    # final-polish ones
    Gl_mul, GlT_mul, Gall_mul = g_ops

    def Gx(v):
        """Stacked G @ v: returns (lp part, psd part)."""
        lp = Gl_mul(v) if p else jnp.zeros(0, dtype=v.dtype)
        psd = jnp.einsum('i,binm->bnm', v, Aj) if nb else None
        return lp, psd

    def GT(u_lp, U_psd):
        out = GlT_mul(u_lp) if p else jnp.zeros(nx, dtype=cj.dtype)
        if nb:
            out = out + jnp.einsum('binm,bnm->i', Aj, U_psd)
        return out

    # residuals of the HSD system
    Ax_lp, Ax_psd = Gx(x)
    rd = GT(z_lp, Z) + cj * tau                     # G^T z + c tau
    rp_lp = hlj * tau - Ax_lp - s_lp if p else s_lp[:0]
    Rp = (Hj * tau - Ax_psd - S) if nb else Hj
    hz = (hlj @ z_lp if p else 0.0) + (jnp.sum(Hj * Z) if nb else 0.0)
    rg = -cj @ x - hz - kappa                       # gap residual

    gap_cones = (s_lp @ z_lp if p else 0.0)
    if nb:
        gap_cones = gap_cones + jnp.sum(S * Z)
    mu = (gap_cones + tau * kappa) / nu

    # NT scalings and the (tau-free) normal matrix
    d_lp = z_lp / s_lp if p else s_lp               # (W^T W)^{-1} diag, LP
    structured = gl_diag.shape[0] == nx

    def hmat_lp():
        if not structured:
            return (Glj.T * d_lp) @ Glj
        H = jnp.diag(d_lp[:nx] * gl_diag ** 2)
        if Rj.shape[0]:
            H = H + jnp.einsum('ri,r,rj->ij', Rj, d_lp[nx:], Rj)
        return H

    if nb:
        Tinv, Rnt, Rinv, lam = _nt_scaling(S, Z)
        # R^T Z R = diag(lam)  =>  Z^{-1} = R diag(1/lam) R^T -- free from
        # the NT factors (replaces a per-iteration batched eigh)
        Zinv = _sym(jnp.einsum('bij,bj,bkj->bik', Rnt, 1.0 / lam, Rnt))
        TinvH = _sym(jnp.einsum('bij,bjl,blm->bim', Tinv, Hj, Tinv))
        if not woodbury:
            # (A kron reformulation of this contraction -- vec(T A T) =
            # (T (x) T) vec(A) as one (nx, n^2)@(n^2, n^2) matmul per block
            # -- was measured in-program at L=3301 and is NOT faster than
            # the einsum once machine-speed drift is controlled for:
            # einsum 1.69s/iter vs kron 1.91s/iter in the same window, with
            # the Y contraction ~0.5s/iter of either (by ablation).  Host
            # machine throughput here swings ~2x between runs; only
            # same-window comparisons are meaningful.)
            Y = jnp.einsum('bij,bkjl,blm->bkim', Tinv, Aj, Tinv)
            Hmat = jnp.einsum('binm,bknm->ik', Aj, Y)
            if p:
                Hmat = Hmat + hmat_lp()
    else:
        TinvH = Hj
        if not woodbury:
            Hmat = hmat_lp()

    if woodbury:
        # Hmat = diag(d0) + W W^T, never materialized (module docstring;
        # VERDICT r2 item 1).  Requires the structured-Gl form.
        d0 = d_lp[:nx] * gl_diag ** 2
        parts = [Rj.T * jnp.sqrt(d_lp[nx:])[None, :]]
        if nb:
            Mb = jnp.einsum('baj,bijl,bcl->biac', Rinv, Aj, Rinv)
            parts.append(_psd_lowrank_factor(Mb))
        W = jnp.concatenate(parts, axis=1)
        Hfac = _wood_factor(d0, W)
        hsolve = partial(_wood_apply, Hfac)
    else:
        Hfac = _chol_factor(Hmat)
        hsolve = partial(_chol_apply, Hfac)

    def Winv2(u_lp, U_psd):
        """(W^T W)^{-1} applied blockwise."""
        lp = d_lp * u_lp if p else u_lp
        psd = _sym(jnp.einsum('bij,bjl,blm->bim', Tinv, U_psd, Tinv)) \
            if nb else U_psd
        return lp, psd

    q = GT(d_lp * hlj if p else hlj[:0], TinvH if nb else None)
    hWh = (hlj @ (d_lp * hlj) if p else 0.0)
    if nb:
        hWh = hWh + jnp.sum(Hj * TinvH)

    v1 = hsolve(cj - q)
    denom = (cj + q) @ v1 + hWh + kappa / tau

    def direction(fr, bs_lp, Bs_psd, bk):
        """Newton direction for rhs scale ``fr`` on (rd, rp, rg) and the
        given complementarity targets.  See module docstring."""
        bx = fr * rd
        bz_lp = fr * rp_lp
        Bz_psd = fr * Rp if nb else Rp
        bt = fr * rg
        wb_lp, Wb_psd = Winv2(bz_lp + bs_lp, (Bz_psd + Bs_psd) if nb else Bs_psd)
        rx = -bx + GT(wb_lp, Wb_psd)
        v2 = hsolve(rx)
        rt = (-bt - bk / tau
              - (hlj @ wb_lp if p else 0.0)
              - (jnp.sum(Hj * Wb_psd) if nb else 0.0))
        dtau = (rt + (cj + q) @ v2) / denom
        dx = v2 - dtau * v1
        Adx_lp, Adx_psd = Gx(dx)
        # dz = (W^T W)^{-1} (G dx - h dtau - (bz + bs))
        dz_lp, dZ = Winv2(
            (Adx_lp - hlj * dtau - bz_lp - bs_lp) if p else bz_lp,
            (Adx_psd - Hj * dtau - Bz_psd - Bs_psd) if nb else Bs_psd)
        ds_lp = (bz_lp + hlj * dtau - Adx_lp) if p else bz_lp
        dS = (Bz_psd + Hj * dtau - Adx_psd) if nb else Bs_psd
        dkappa = (-bk - kappa * dtau) / tau
        return dx, ds_lp, dS, dz_lp, dZ, dtau, dkappa

    def max_steps(ds_lp, dS, dz_lp, dZ, dtau, dkappa):
        a = jnp.minimum(_max_step_scalar(tau, dtau),
                        _max_step_scalar(kappa, dkappa))
        if p:
            a = jnp.minimum(a, _max_step_lp(s_lp, ds_lp))
            a = jnp.minimum(a, _max_step_lp(z_lp, dz_lp))
        if nb:
            a = jnp.minimum(a, _max_step_psd(S, dS))
            a = jnp.minimum(a, _max_step_psd(Z, dZ))
        return a

    zero_psd = jnp.zeros_like(S) if nb else S
    zero_lp = jnp.zeros_like(s_lp)

    # predictor (affine scaling): full residual, complementarity -> 0
    aff = direction(1.0, s_lp, S if nb else zero_psd, tau * kappa)
    dxa, dsa_lp, dSa, dza_lp, dZa, dtaua, dkappaa = aff
    a_aff = jnp.minimum(1.0, max_steps(dsa_lp, dSa, dza_lp, dZa,
                                       dtaua, dkappaa))

    gap_aff = (((s_lp + a_aff * dsa_lp) @ (z_lp + a_aff * dza_lp))
               if p else 0.0)
    if nb:
        gap_aff = gap_aff + jnp.sum((S + a_aff * dSa) * (Z + a_aff * dZa))
    gap_aff = gap_aff + (tau + a_aff * dtaua) * (kappa + a_aff * dkappaa)
    gap_tot = gap_cones + tau * kappa
    sigma = jnp.clip((gap_aff / gap_tot) ** 3, 1e-8, 1.0)

    # Mehrotra second-order corrections
    corr_lp = dsa_lp * dza_lp / z_lp if p else zero_lp
    if nb:
        # corr = W^T( lam o^{-1} [(W^-T dS) o (W dZ)] ) with lam diagonal
        # so (lam o X)_{ij} = (lam_i + lam_j)/2 X_{ij}
        dSs = Rinv @ dSa @ jnp.swapaxes(Rinv, -1, -2)       # W^{-T} dS
        dZs = jnp.swapaxes(Rnt, -1, -2) @ dZa @ Rnt         # W dZ
        Q = _sym(dSs @ dZs)
        denom_l = (lam[:, :, None] + lam[:, None, :]) / 2.0
        corr_psd = _sym(Rnt @ (Q / denom_l) @ jnp.swapaxes(Rnt, -1, -2))
    else:
        corr_psd = zero_psd

    smu = sigma * mu
    comb = direction(1.0 - sigma,
                     (s_lp - smu / z_lp + corr_lp) if p else zero_lp,
                     (S - smu * Zinv + corr_psd) if nb else zero_psd,
                     tau * kappa - smu + dtaua * dkappaa)
    dx, ds_lp, dS, dz_lp, dZ, dtau, dkappa = comb
    a_comb = max_steps(ds_lp, dS, dz_lp, dZ, dtau, dkappa)

    # Gondzio multiple centrality correctors on the LP block + tau/kappa
    # (the active-set degeneracy lives in the m >= 0 rows; the PSD blocks
    # are small and stay well-centered).  Each corrector is one extra
    # hsolve -- nearly free under the Woodbury factorization -- and is
    # accepted only if it widens the cone step.  Classic recipe: at a
    # trial step beyond a_comb, clip the trial complementarity products
    # into [0.1, 10] * sigma*mu and solve for the correction with zero
    # residual part (fr = 0).
    for _ in range(_GONDZIO):
        _, dsl, _, dzl, _, dtl, dkl = comb
        at = jnp.minimum(1.0, a_comb + 0.3)
        mu_t = smu
        if p:
            v_lp = (s_lp + at * dsl) * (z_lp + at * dzl)
            t_lp = jnp.clip(v_lp, 0.1 * mu_t, 10.0 * mu_t)
            bs_corr = (v_lp - t_lp) / z_lp
        else:
            bs_corr = zero_lp
        v_tk = (tau + at * dtl) * (kappa + at * dkl)
        t_tk = jnp.clip(v_tk, 0.1 * mu_t, 10.0 * mu_t)
        corr = direction(0.0, bs_corr, zero_psd, v_tk - t_tk)
        cand = tuple(d + dc for d, dc in zip(comb, corr))
        a_cand = max_steps(*cand[1:])
        accept = a_cand > jnp.minimum(1.03 * a_comb, 0.999)
        comb = tuple(jnp.where(accept, cn, cv)
                     for cn, cv in zip(cand, comb))
        a_comb = jnp.where(accept, a_cand, a_comb)
    dx, ds_lp, dS, dz_lp, dZ, dtau, dkappa = comb

    # Mehrotra safeguard: on ill-conditioned problems the second-order
    # correction can overshoot the cone and collapse the step; fall back
    # to the pure centering direction when that happens.  The fallback is
    # rarely taken, so its third direction() solve + cone line search run
    # under lax.cond instead of unconditionally every iteration.
    use_fallback = a_comb < 0.2 * a_aff

    def cent_branch(_):
        smu2 = jnp.maximum(sigma, 0.5) * mu
        cent = direction(1.0 - jnp.maximum(sigma, 0.5),
                         (s_lp - smu2 / z_lp) if p else zero_lp,
                         (S - smu2 * Zinv) if nb else zero_psd,
                         tau * kappa - smu2)
        return cent + (max_steps(*cent[1:]),)

    def comb_branch(_):
        return comb + (a_comb,)

    (dx, ds_lp, dS, dz_lp, dZ, dtau, dkappa, a_max) = jax.lax.cond(
        use_fallback, cent_branch, comb_branch, None)

    a = jnp.minimum(1.0, step_frac * a_max)

    x_n = x + a * dx
    s_lp_n = s_lp + a * ds_lp
    z_lp_n = z_lp + a * dz_lp
    S_n = _sym(S + a * dS) if nb else S
    Z_n = _sym(Z + a * dZ) if nb else Z
    tau_n = tau + a * dtau
    kappa_n = kappa + a * dkappa

    # dual polish: minimum-norm correction restoring G^T z + c tau = 0,
    # applied only when it keeps z strictly inside the cone.  Late
    # iterations otherwise lose dual feasibility to cancellation when
    # recovering dz through (W^T W)^{-1}, stalling dres at ~1e-4.
    # gate: polish once the dual residual is small relative to the data --
    # a large projection mid-run throws the iterate off the central path.
    # The bound is loose (1e-2) because the cone max-step already rejects
    # corrections that would leave the interior, and the late-stage dz
    # recovery through (W^T W)^{-1} can inject O(1e-4) error in a single
    # step right at convergence.
    z_lp_n, Z_n = _dual_polish(
        GT, Gall_mul, gsolve, p, nb, n, cj, z_lp_n, Z_n, tau_n,
        lambda rd: jnp.where(jnp.linalg.norm(rd) < 1e-2 * cnorm * tau_n,
                             1.0, 0.0))

    return (x_n, s_lp_n, S_n, z_lp_n, Z_n, tau_n, kappa_n,
            gap_cones, jnp.linalg.norm(
                jnp.concatenate([rp_lp, Rp.reshape(-1)])
                if nb else rp_lp),
            jnp.linalg.norm(rd), a)


# --------------------------- fused full solve ----------------------------- #

@partial(jax.jit, static_argnames=("verbose", "woodbury"))
def _ipm_solve(cj, Glj, hlj, Aj, Hj, _Gall_j, _GtG_j, gl_diag, Rj,
               wx, ws_lp, wS, wz_lp, wZ, wlam,
               cnorm, hnorm, step_frac, tol, feastol, max_iter,
               verbose=False, woodbury=False):
    """Full HSD-IPM solve as one compiled program.

    Initialization (least-squares start + cvxopt-style interior shift), the
    predictor-corrector loop, and stall / best-iterate / convergence
    bookkeeping all run device-side in a single ``lax.while_loop``.
    Residuals and objective are tracked on the de-homogenized point x/tau.

    done codes: 0 running, 1 converged, 2 non-finite, 3 stall/tiny-step,
    4 tau collapse (infeasible or numerically dead embedding).
    """
    p = hlj.shape[0]
    nb, nx, n, _ = Aj.shape
    eye_n = jnp.eye(n, dtype=Hj.dtype)

    if woodbury:
        # implicit structured G (see _iteration_core): Glj/_Gall_j are
        # dummies here, never shipped to the device
        def Gl_mul(v):
            return jnp.concatenate([gl_diag * v, Rj @ v])

        def GlT_mul(u):
            return gl_diag * u[:nx] + Rj.T @ u[nx:]

        def Gall_mul(v):
            parts = [Gl_mul(v)]
            if nb:
                parts.append(jnp.einsum('binm,i->bnm', Aj,
                                        v).reshape(nb * n * n))
            return jnp.concatenate(parts)

        def GallT_mul(u):
            out = GlT_mul(u[:p])
            if nb:
                out = out + jnp.einsum(
                    'binm,bnm->i', Aj, u[p:].reshape(nb, n, n))
            return out
    else:
        def Gl_mul(v):
            return Glj @ v

        def GlT_mul(u):
            return Glj.T @ u

        def Gall_mul(v):
            return _Gall_j @ v

        def GallT_mul(u):
            return _Gall_j.T @ u

    # ----- initialization: least-squares primal/dual start at tau = 1 -----
    hall = jnp.concatenate([hlj, Hj.reshape(nb * n * n)]
                           if nb else [hlj], axis=0)
    if woodbury:
        # G^T G = diag(gl^2) + R^T R + sum_b vec(A_i).vec(A_k): the same
        # diag + low-rank structure as the normal matrix (the host never
        # materializes the nx x nx Gram at all -- _GtG_j is a dummy here)
        parts0 = [Rj.T]
        if nb:
            parts0.append(_psd_lowrank_factor(Aj))
        Gfac = _wood_factor(gl_diag ** 2, jnp.concatenate(parts0, axis=1))
        gsolve = partial(_wood_apply, Gfac)
    else:
        Gfac = _chol_factor(_GtG_j)   # constant: factor once per solve
        gsolve = partial(_chol_apply, Gfac)
    x0 = gsolve(GallT_mul(hall))
    z_all = Gall_mul(gsolve(-cj))
    s_lp = hlj - Gl_mul(x0)
    S = Hj - jnp.einsum('i,binm->bnm', x0, Aj) if nb else Hj
    z_lp = z_all[:p]
    Z = _sym(z_all[p:].reshape(nb, n, n)) if nb else Hj

    # shift initial points into the cone interior (cvxopt-style)
    def shift_lp(v):
        if p == 0:
            return v
        m = jnp.min(v)
        return jnp.where(m < 1e-8, v + jnp.maximum(0.0, -m) + 1.0, v)

    def shift_psd(V):
        if nb == 0:
            return V
        lam = jnp.min(jnp.linalg.eigvalsh(V))
        return jnp.where(lam < 1e-8,
                         V + (1.0 - jnp.minimum(lam, 0.0)) * eye_n[None], V)

    s_lp = shift_lp(s_lp)
    z_lp = shift_lp(z_lp)
    S = shift_psd(S)
    Z = shift_psd(Z)
    one = jnp.asarray(1.0, cj.dtype)

    # ----- optional warm start (VERDICT r5 item 3) -----
    # Blend a cached previous solution of the SAME program into the cold
    # start (Skajaa/Jorgensen/Andersen-style HSD warm start): the HSD
    # initialization is an arbitrary interior point, so blending is
    # always admissible.  wlam is a TRACED scalar -- wlam = 0.0 (the
    # cold path) is bit-exact the historical start and reuses the same
    # compiled program.  Active constraints in the warm point sit on the
    # boundary, so blended slacks get an elementwise interior floor
    # (scaled by how warm we are; exactly 0 when cold) and kappa moves
    # to the blended complementarity mean to stay near the central path.
    lam_w = wlam
    one_m = one - lam_w
    x0 = one_m * x0 + lam_w * wx
    if p:
        ds = lam_w * 1e-6 * (one + jnp.mean(jnp.abs(s_lp)))
        dz = lam_w * 1e-6 * (one + jnp.mean(jnp.abs(z_lp)))
        s_lp = jnp.maximum(one_m * s_lp + lam_w * ws_lp, ds)
        z_lp = jnp.maximum(one_m * z_lp + lam_w * wz_lp, dz)
    if nb:
        dS = lam_w * 1e-6 * (one + jnp.mean(jnp.abs(S)))
        dZ = lam_w * 1e-6 * (one + jnp.mean(jnp.abs(Z)))

        def psd_floor(V, delta):
            lam_min = jnp.min(jnp.linalg.eigvalsh(V), axis=-1)
            add = jnp.maximum(delta - lam_min, 0.0)
            return V + add[:, None, None] * eye_n[None]

        S = psd_floor(one_m * S + lam_w * _sym(wS), dS)
        Z = psd_floor(one_m * Z + lam_w * _sym(wZ), dZ)
    nu_f = p + nb * n
    mu0 = (((s_lp @ z_lp) if p else 0.0)
           + (jnp.sum(S * Z) if nb else 0.0)) / max(nu_f, 1)
    kappa0 = one_m * one + lam_w * jnp.maximum(mu0, 1e-10)

    # ----- fused iteration loop with best-iterate tracking -----
    # on degenerate optimal faces the duality gap can hit the f64 floor
    # while a residual sits just above tolerance -- keep the best point.
    inf = jnp.asarray(jnp.inf)
    state = dict(
        it=jnp.asarray(0, jnp.int32),
        x=x0, s_lp=s_lp, S=S, z_lp=z_lp, Z=Z, tau=one, kappa=kappa0,
        best_merit=inf, best_x=x0, best_gap=inf, best_pres=inf,
        best_dres=inf, best_pobj=jnp.asarray(jnp.nan),
        stall=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(0, jnp.int32),
    )

    def cond(st):
        return (st["it"] < max_iter) & (st["done"] == 0)

    def body(st):
        (x_n, s_n, S_n, z_n, Z_n, tau_n, kappa_n,
         gap_r, pres_r, dres_r, a) = _iteration_core(
            cj, Glj, hlj, Aj, Hj, (Gl_mul, GlT_mul, Gall_mul), gsolve,
            cnorm, step_frac, gl_diag, Rj, woodbury,
            st["x"], st["s_lp"], st["S"], st["z_lp"], st["Z"],
            st["tau"], st["kappa"])
        it = st["it"] + 1
        tau = st["tau"]
        # de-homogenized metrics of the pre-step iterate
        gap = gap_r / tau ** 2
        pres = pres_r / tau / hnorm
        dres = dres_r / tau / cnorm
        pobj = (cj @ st["x"]) / tau
        finite = (jnp.isfinite(gap) & jnp.isfinite(pres)
                  & jnp.isfinite(dres) & jnp.isfinite(pobj))

        relgap = gap / jnp.maximum(1.0, jnp.abs(pobj))
        # best-iterate merit on a common scale: relgap converges against
        # tol while pres/dres converge against feastol, so relgap is
        # weighted by feastol/tol (identity at the defaults) -- otherwise
        # a feastol > tol run can shadow a converged iterate behind an
        # earlier lower-residual, higher-gap one
        merit = jnp.maximum(relgap * (feastol / tol),
                            jnp.maximum(pres, dres))
        improved = finite & (merit < st["best_merit"])
        if verbose:
            jax.debug.print(
                "ipm {it}: gap={g:.2e} pres={p:.2e} dres={d:.2e} "
                "tau={t:.2e} kappa={k:.2e} step={a:.3f}",
                it=it, g=relgap, p=pres, d=dres, t=tau,
                k=st["kappa"], a=a)

        converged = (pres < feastol) & (dres < feastol) & (relgap < tol)
        stall = jnp.where(improved, 0, st["stall"] + 1).astype(jnp.int32)
        stall_limit = jnp.where((pres < 1e-6) & (dres < 1e-6), 30, 60)
        # endgame: once the best iterate is already deep inside the
        # "inaccurate" acceptance zone (relgap/res floors of f64 on
        # degenerate faces), a short no-improvement plateau means the
        # floors are reached -- running to the full stall limit only
        # burns iterations and usually ends in a NaN factorization
        endgame = (st["best_merit"] < 1e2 * tol) & (stall >= 4)
        stalled = (stall >= stall_limit) | (a < 1e-10) | endgame
        tau_dead = tau_n < 1e-12
        done = jnp.where(~finite, 2,
                         jnp.where(converged, 1,
                                   jnp.where(tau_dead, 4,
                                             jnp.where(stalled, 3, 0)))
                         ).astype(jnp.int32)

        def upd(new, old):
            return jnp.where(finite, new, old)

        return dict(
            it=it,
            x=upd(x_n, st["x"]), s_lp=upd(s_n, st["s_lp"]),
            S=upd(S_n, st["S"]), z_lp=upd(z_n, st["z_lp"]),
            Z=upd(Z_n, st["Z"]), tau=upd(tau_n, st["tau"]),
            kappa=upd(kappa_n, st["kappa"]),
            best_merit=jnp.where(improved, merit, st["best_merit"]),
            best_x=jnp.where(improved, st["x"] / tau, st["best_x"]),
            best_gap=jnp.where(improved, gap, st["best_gap"]),
            best_pres=jnp.where(improved, pres, st["best_pres"]),
            best_dres=jnp.where(improved, dres, st["best_dres"]),
            best_pobj=jnp.where(improved, pobj, st["best_pobj"]),
            stall=stall,
            done=done,
        )

    st = jax.lax.while_loop(cond, body, state)

    # fold in the final iterate (the loop records metrics pre-step, so the
    # last point produced would otherwise never be a "best" candidate),
    # with a last unconditional-gate dual polish: the primal is typically
    # excellent here while z carries one step's worth of (W^T W)^{-1}
    # recovery noise
    tau = st["tau"]
    x = st["x"]

    def GT_f(zl, Zm):
        out = GlT_mul(zl) if p else 0.0
        if nb:
            out = out + jnp.einsum('binm,bnm->i', Aj, Zm)
        return out

    z_lp_f, Z_f = _dual_polish(
        GT_f, Gall_mul, gsolve, p, nb, n, cj, st["z_lp"], st["Z"], tau,
        lambda rd: jnp.asarray(1.0))   # unconditional gate
    rd = cj * tau + GT_f(z_lp_f, Z_f)
    rp_lp = hlj * tau - Gl_mul(x) - st["s_lp"] if p else st["s_lp"][:0]
    parts = [rp_lp]
    if nb:
        Rp = Hj * tau - jnp.einsum('i,binm->bnm', x, Aj) - st["S"]
        parts.append(Rp.reshape(-1))
    gap_f = ((st["s_lp"] @ z_lp_f if p else 0.0)
             + (jnp.sum(st["S"] * Z_f) if nb else 0.0)) / tau ** 2
    pres_f = jnp.linalg.norm(jnp.concatenate(parts)) / tau / hnorm
    dres_f = jnp.linalg.norm(rd) / tau / cnorm
    pobj_f = (cj @ x) / tau
    relgap_f = gap_f / jnp.maximum(1.0, jnp.abs(pobj_f))
    # same (feastol / tol) relgap weighting as the in-loop merit -- the
    # two are compared against each other, so an unweighted fold-in
    # could displace a strictly better converged iterate whenever
    # feastol != tol
    merit_f = jnp.maximum(relgap_f * (feastol / tol),
                          jnp.maximum(pres_f, dres_f))
    fin = (jnp.isfinite(merit_f) & (tau > 1e-12)
           & (merit_f < st["best_merit"]))
    best_merit = jnp.where(fin, merit_f, st["best_merit"])
    best_x = jnp.where(fin, x / tau, st["best_x"])
    best_gap = jnp.where(fin, gap_f, st["best_gap"])
    best_pres = jnp.where(fin, pres_f, st["best_pres"])
    best_dres = jnp.where(fin, dres_f, st["best_dres"])
    best_pobj = jnp.where(fin, pobj_f, st["best_pobj"])

    # (in)feasibility certificate data at the final (un-normalized)
    # iterate, for the host-side discrimination of a tau collapse
    # (done == 4): primal infeasible <=> a dual ray (G'z ~ 0, h'z < 0);
    # unbounded <=> a primal ray (Gx + s ~ 0, c'x < 0); neither -- with
    # kappa collapsed too -- is a numerically dead embedding, not a
    # certificate.
    uz = (jnp.concatenate([st["z_lp"], st["Z"].reshape(-1)]) if nb
          else st["z_lp"])
    s_all = (jnp.concatenate([st["s_lp"], st["S"].reshape(-1)]) if nb
             else st["s_lp"])
    z_nrm = jnp.maximum(jnp.linalg.norm(uz), 1e-300)
    x_nrm = jnp.maximum(jnp.linalg.norm(x), 1e-300)
    htz_rel = ((hlj @ st["z_lp"]
                + (jnp.sum(Hj * st["Z"]) if nb else 0.0)) / z_nrm)
    zres_rel = jnp.linalg.norm(GallT_mul(uz)) / z_nrm
    xres_rel = jnp.linalg.norm(Gall_mul(x) + s_all) / x_nrm
    ctx_rel = (cj @ x) / x_nrm
    kap_rel = st["kappa"] / jnp.maximum(1.0, jnp.maximum(z_nrm, x_nrm))

    # de-homogenized FINAL iterate for the caller's warm-start cache (at
    # convergence it coincides with the best point; the caller only
    # stores it on an OK status, so the divergent-tau guard below is a
    # numerical safety, not a semantic one)
    tau_safe = jnp.maximum(tau, 1e-300)
    return (best_merit, best_x, best_gap, best_pres,
            best_dres, best_pobj, st["it"], st["done"],
            kap_rel, htz_rel, zres_rel, ctx_rel, xres_rel,
            x / tau_safe, st["s_lp"] / tau_safe, st["S"] / tau_safe,
            st["z_lp"] / tau_safe, st["Z"] / tau_safe)


# ------------------------------- solver ---------------------------------- #

def _dispatch_ipm(arrays, cnorm, hnorm, step_frac, tol, feastol, max_iter,
                  verbose, woodbury):
    """Raw dispatch of the fused IPM program in THIS process (used by the
    crash-isolation worker, and directly when isolation is disabled)."""
    return _ipm_solve(*arrays, cnorm, hnorm, step_frac, tol, feastol,
                      max_iter, verbose=verbose, woodbury=woodbury)


def _run_ipm(arrays_np, cnorm, hnorm, step_frac, tol, feastol, max_iter,
             verbose, woodbury):
    """Dispatch the fused IPM program, crash-isolated by default.

    ``arrays_np`` are host numpy.  This build's XLA:CPU PJRT surface
    intermittently SEGFAULTS on this module (compile, executable
    serialize AND cache-read deserialize -- see solvers/ipm_worker.py
    for the full post-mortem), so the dispatch runs in a persistent
    worker subprocess whose crash costs a restart + retry instead of
    the user's process.  BLUEST_TPU_IPM_ISOLATE=0 dispatches in-process
    (debugging).  (A jax.export StableHLO disk cache was tried earlier
    to also skip the ~1s per-process trace+lower; deserialized exports
    of this module crash/hang the same way.)"""
    # the worker pins jax_platforms=cpu (the crash is XLA:CPU-specific),
    # so isolation only applies while the allocation runs on the CPU
    # backend (the default); under BLUEST_TPU_ALLOC_DEVICE=default the
    # dispatch stays in-process on the main device as documented
    if (os.environ.get("BLUEST_TPU_IPM_ISOLATE", "1") != "0"
            and os.environ.get("BLUEST_TPU_ALLOC_DEVICE", "cpu") == "cpu"):
        from .ipm_worker import get_client
        return get_client().run(
            (tuple(np.asarray(a) for a in arrays_np), cnorm, hnorm,
             step_frac, tol, feastol, max_iter, verbose, woodbury))
    arrays = tuple(jnp.asarray(a) for a in arrays_np)
    return _dispatch_ipm(arrays, cnorm, hnorm, step_frac, tol, feastol,
                         max_iter, verbose, woodbury)


_WARMED = set()
_WARMED_LOCK = __import__("threading").Lock()


def prewarm_mlblue(L: int, No: int, n: int,
                   budget_epigraph: bool = False, n_caps: int = 0) -> None:
    """Trace + compile the fused IPM program for an MLBLUE shape class.

    The per-process TRACE+LOWER of the while_loop program (~1.3 s at
    L ~ 3300) is the dominant cold-allocation cost and the persistent XLA
    cache cannot remove it (it only skips backend compilation).  The
    program's jit cache key is (shapes, statics) only, so running a
    trivial dummy instance of the SAME shape with max_iter=1 (max_iter is
    a traced scalar) populates the cache for the real solve.  MOSAP
    construction calls this from a daemon thread so the trace overlaps
    psi/invcovs assembly (VERDICT r2 item 4).

    Shape contract (allocation/cones.py): direct-eps programs have
    nx = L, p = L + No + n_caps; budget-epigraph programs nx = L + 1,
    p = L + 2 + No + n_caps, where n_caps is the number of finite
    per-model sample caps (one Gl row each).
    """
    key = (int(L), int(No), int(n), bool(budget_epigraph), int(n_caps))
    with _WARMED_LOCK:
        if key in _WARMED:
            return
        _WARMED.add(key)
    rng = np.random.default_rng(0)
    nx = L + 1 if budget_epigraph else L
    c = np.ones(nx)
    # rows beyond the -eye block: budget row + No coverage rows for the
    # epigraph form (p = nx + 1 + No = L + 2 + No), No coverage rows for
    # the direct-eps form; per-model caps add one row each in both forms
    extra = (1 + No if budget_epigraph else No) + int(n_caps)
    Gl = np.vstack([-np.eye(nx), rng.random((extra, nx))])
    hl = np.concatenate([np.zeros(nx), np.full(extra, float(nx))])
    v = rng.standard_normal((No, nx, n))
    As = -v[..., None] * v[..., None, :]        # random PSD slices
    Hs = np.tile(np.eye(n), (No, 1, 1)) * float(nx)
    try:
        res = solve_cone_lp(c, Gl, hl, As, Hs, max_iter=1)
        if res.status == "failed":
            # the warm-up itself failed through the worker-infra path
            # (returned, not raised): nothing was traced -- allow a retry
            _WARMED.discard(key)
    except Exception:                            # pragma: no cover
        _WARMED.discard(key)


# --------------------------- warm-start cache ----------------------------- #
# Process-level cache of final HSD iterates keyed by a content hash of the
# (post-equilibration) program data: EXACT re-solves of the same cone
# program -- MOSAP rebuilds, repeated budget-calibration solves, bench
# steady-state reps -- seed the next solve from the previous solution and
# converge in a handful of iterations instead of ~34 (VERDICT r5 item 3).
# Safety: a content-hash key cannot cross-seed different instances, a
# non-OK warm outcome falls back to the bit-exact cold start in the same
# compiled program, and only finite OK-status iterates are stored.
# BLUEST_TPU_IPM_WARM=0 disables; BLUEST_TPU_IPM_WARM_LAMBDA tunes the
# blend weight (default 0.99).
_WARM_CACHE: dict = {}
_WARM_LOCK = threading.Lock()
_WARM_CACHE_MAX = 8
_WARM_OK = ("optimal", "inaccurate")


def _warm_fingerprint(base_arrays, nx, p, nb, n) -> str:
    """Content hash of the cone program (post-equilibration arrays).

    Hashes the compact structured pieces (gl_diag/R when the [-diag;
    rows] split is active the dense Gl/Gram never reach the device, so
    hashing them would double the memory traffic for nothing)."""
    c_np, Gl_dev, hl_np, As_np, Hs_np, _Gall, _GtG, gl_diag, R_np = \
        base_arrays
    h = hashlib.sha1()
    h.update(np.asarray([nx, p, nb, n], dtype=np.int64).tobytes())
    for a in (c_np, hl_np, As_np, Hs_np, gl_diag, R_np):
        h.update(np.ascontiguousarray(a).tobytes())
    if gl_diag.shape[0] != nx:          # unstructured Gl: hash it whole
        h.update(np.ascontiguousarray(Gl_dev).tobytes())
    return h.hexdigest()


def solve_cone_lp(c: np.ndarray,
                  Gl: Optional[np.ndarray],
                  hl: Optional[np.ndarray],
                  As: Optional[np.ndarray] = None,
                  Hs: Optional[np.ndarray] = None,
                  tol: float = 1.0e-8,
                  feastol: float = 1.0e-8,
                  max_iter: int = 200,
                  step_frac: float = 0.99,
                  equilibrate: bool = True,
                  verbose: bool = False,
                  woodbury: Optional[bool] = None) -> ConeLPResult:
    """Solve  min c^T x  s.t.  Gl x <= hl,  sum_i x_i As[b,i] <= Hs[b].

    ``As``: (nb, nx, n, n) symmetric coefficient slices; ``Hs``: (nb, n, n).
    Host numpy in, host numpy out; the entire solve is one fused dispatch.
    """
    c_np = np.asarray(c, dtype=np.float64)
    nx = c_np.shape[0]
    if Gl is None:
        Gl = np.zeros((0, nx))
        hl = np.zeros((0,))
    Gl_np = np.asarray(Gl, dtype=np.float64).reshape(-1, nx)
    hl_np = np.asarray(hl, dtype=np.float64).ravel()
    p = Gl_np.shape[0]
    if As is None:
        As = np.zeros((0, nx, 1, 1))
        Hs = np.zeros((0, 1, 1))
    As_np = np.asarray(As, dtype=np.float64)
    As_np = (As_np + np.swapaxes(As_np, -1, -2)) / 2
    Hs_np = np.asarray(Hs, dtype=np.float64)
    Hs_np = (Hs_np + np.swapaxes(Hs_np, -1, -2)) / 2
    nb, _, n, _ = As_np.shape

    # Column (variable) equilibration: x = colscale * x_tilde.  MLBLUE
    # LMI coefficient columns span many orders of magnitude when model
    # correlations approach 1 (group inverse-covariance blocks ~1/(1-rho^2))
    # and the IPM normal matrix would square that range.
    colscale = np.ones(nx)
    if equilibrate:
        norms = np.sqrt((Gl_np ** 2).sum(axis=0)
                        + (As_np ** 2).sum(axis=(0, 2, 3)))
        # a variable appearing in no constraint has norm 0; leave it
        # unscaled (1/1e-150 would overflow c and the Gram matrix)
        colscale = np.where(norms > 1e-150, 1.0 / np.maximum(norms, 1e-150),
                            1.0)
        Gl_np = Gl_np * colscale[None, :]
        As_np = As_np * colscale[None, :, None, None]
        c_np = c_np * colscale
    nu = p + nb * n
    if nu == 0:
        raise ValueError("empty cone")

    hnorm = max(1.0, float(np.linalg.norm(hl_np)) + float(np.linalg.norm(Hs_np)))
    cnorm = max(1.0, float(np.linalg.norm(c_np)))

    # structured-Gl detection: MLBLUE programs are [-diag; few rows].
    # hmat_lp handles zero diagonal entries fine, so the structured
    # assembly stays on even then; only the Woodbury path (which divides
    # by gl_diag^2 in _wood_factor) additionally needs a fully nonzero
    # diagonal -- see diag_ok below.
    if p >= nx and np.count_nonzero(
            Gl_np[:nx] - np.diag(np.diag(Gl_np[:nx]))) == 0:
        gl_diag = np.diag(Gl_np[:nx]).copy()
        R_np = Gl_np[nx:]
    else:
        gl_diag = np.zeros(0)
        R_np = np.zeros((0, nx))
    diag_ok = gl_diag.shape[0] == nx and bool(np.all(gl_diag != 0))

    # Woodbury fast path (VERDICT r2 item 1): with structured Gl the
    # normal matrix is diag + rank-r, r = extra LP rows + nb*n(n+1)/2.
    # Auto-enable when the rank gap pays for the capacitance detour; the
    # small-nx dense path keeps its long-validated numerics.  Measured
    # crossover is near nx ~ r (the dense path also pays the O(nb nx^2
    # n^2) Hmat formation): at L=385, r=201 the capacitance path is
    # already 1.7x faster per solve at identical quality.
    rank_lr = (p - nx) + nb * (n * (n + 1)) // 2
    if woodbury is None:
        woodbury = (diag_ok and nx >= 256
                    and 2 * nx >= 3 * rank_lr)
    elif woodbury and not diag_ok:
        raise ValueError("woodbury=True requires the structured "
                         "[-diag; rows] Gl form with a fully nonzero "
                         "diagonal")

    if woodbury:
        # G is applied implicitly from (gl_diag, R, As): the dense
        # (p, nx) Gl, the stacked (p + nb n^2, nx) constraint matrix and
        # the nx x nx Gram never reach the device (each is O(L^2) memory
        # -- the scaling wall at L ~ 1e4)
        Gl_dev = np.zeros((1, 1))
        Gall_dev = np.zeros((1, 1))
        GtG = np.zeros((1, 1))
    else:
        # stacked constraint matrix + Gram seed the least-squares start
        if nb:
            _Gall = np.concatenate(
                [Gl_np, As_np.reshape(nb, nx, n * n).transpose(0, 2, 1)
                 .reshape(nb * n * n, nx)], axis=0)
        else:
            _Gall = Gl_np
        Gl_dev = Gl_np
        Gall_dev = _Gall
        GtG = _Gall.T @ _Gall

    base_arrays = (c_np, Gl_dev, hl_np, As_np, Hs_np, Gall_dev, GtG,
                   gl_diag, R_np)
    # --- warm-start lookup (VERDICT r5 item 3): exact re-solves of the
    # same program (MOSAP rebuilds, repeated budget-calibration solves)
    # seed the HSD iterate from the cached previous solution.  The key
    # is a content hash of the post-equilibration data, so a hit implies
    # the identical program; nearby-data reuse is deliberately out of
    # scope (same-shape different instances must never cross-seed).
    warm_entry = None
    fp = None
    if os.environ.get("BLUEST_TPU_IPM_WARM", "1") != "0":
        fp = _warm_fingerprint(base_arrays, nx, p, nb, n)
        with _WARM_LOCK:
            warm_entry = _WARM_CACHE.get(fp)
    zeros_warm = (np.zeros(nx), np.zeros(p), np.zeros((nb, n, n)),
                  np.zeros(p), np.zeros((nb, n, n)))
    wlam = float(os.environ.get("BLUEST_TPU_IPM_WARM_LAMBDA", "0.99"))
    arrays_cold = base_arrays + zeros_warm + (np.float64(0.0),)
    if warm_entry is not None:
        arrays_np = base_arrays + warm_entry + (np.float64(wlam),)
    else:
        arrays_np = arrays_cold
    # problem shape for downstream flops accounting (bench MFU lines);
    # rank is the low-rank part of the normal matrix either way (the
    # dense path still factors the same diag + rank-r operator densely)
    dims_rec = {"nx": int(nx), "p": int(p), "nb": int(nb), "n": int(n),
                "rank": int(max(rank_lr, 0)), "woodbury": bool(woodbury),
                "warm_start": warm_entry is not None}

    def _attempt(frac, arrays):
        """One dispatch + status derivation.
        Returns (result, infra, final_iterate_for_warm_cache)."""
        try:
            (best_merit, best_x, gap, pres, dres, pobj, it, done,
             kap_rel, htz_rel, zres_rel, ctx_rel, xres_rel,
             fx, fs, fS, fz, fZ) = _run_ipm(
                arrays, cnorm, hnorm, frac, tol, feastol, max_iter,
                verbose, bool(woodbury))
        except IPMWorkerInfraError as exc:
            # isolation worker exhausted its retries (infrastructure
            # crash, not a numerical failure): report "failed" so the
            # caller's NLP fallback chain engages instead of killing the
            # user's process.  Deterministic in-worker exceptions
            # (bug-type) PROPAGATE -- see ipm_worker.IPMWorkerClient.run
            # -- so this cannot mask defects.
            if verbose:
                print("cone solve infrastructure failure: %s" % exc)
            return ConeLPResult(x=np.full(nx, np.nan), status="failed",
                                iterations=0, gap=np.inf, pres=np.inf,
                                dres=np.inf, pobj=np.nan,
                                dims=dims_rec), True, None

        it = int(it)
        if not np.isfinite(float(best_merit)):
            return ConeLPResult(x=np.full(nx, np.nan), status="failed",
                                iterations=it, gap=np.inf, pres=np.inf,
                                dres=np.inf, pobj=np.nan,
                                dims=dims_rec), False, None
        gap_f = float(gap)
        pres_f = float(pres)
        dres_f = float(dres)
        pobj_f = float(pobj)
        xb = np.asarray(best_x) * colscale
        relgap = gap_f / max(1.0, abs(pobj_f))
        if pres_f < feastol and dres_f < feastol and relgap < tol:
            status = "optimal"
        elif (pres_f < 1e3 * feastol and dres_f < 1e4 * feastol
              and relgap < 1e4 * tol):
            # the reference's cvxopt defaults run at reltol 1e-4
            # (sap.py:37-43); on degenerate optimal faces the f64 gap
            # floor sits well above the nominal tol while feasibility is
            # at machine precision.  The dual residual (certificate side)
            # gets an extra decade: late-stage (W^T W)^{-1} recovery noise
            # is O(1e-4) relative while the primal point is excellent, and
            # downstream consumers (homogeneity rescale, integer
            # projection) re-establish feasibility exactly.
            status = "inaccurate"
        elif (pres_f < 1e2 * feastol and dres_f < 1e5 * feastol
              and relgap < 1e4 * tol):
            # dres-only overshoot on a PRIMAL-excellent iterate: the
            # recovery-noise class above is not sharply bounded at
            # 1e4*feastol -- on the NS K=7 golden the SAME iterate
            # (relgap 5.6e-5, pres 8e-8) classified dres 2.8e-5 under a
            # 1-device XLA build and 2.1e-4 under the 8-device build,
            # flipping accept -> failed on compilation last-bits alone
            # and cascading into the NLP fallback.  Give dres one more
            # decade iff the primal gates are a decade TIGHTER than the
            # branch above; downstream still only consumes the primal
            # point, and the recorded certificate keeps the true dres.
            status = "inaccurate"
        elif int(done) == 4:
            # tau collapse: the HSD embedding's (in)feasibility
            # certificate.  Distinguished from generic numerical failure
            # so callers and certificates can report it (downstream still
            # treats it as not-OK; e.g. caps contradicting the coverage
            # constraint).  Checked before max_iter: a collapse detected
            # on the last permitted iteration is still a certificate.
            # Discriminate by the final iterate's ray: a dual ray
            # (G'z ~ 0, h'z < 0) certifies primal INFEASIBLE; a primal
            # ray (Gx + s ~ 0, c'x < 0) certifies UNBOUNDED; with kappa
            # collapsed as well and neither ray present the embedding
            # died numerically -- labeling that "infeasible" would feed
            # budget_level_bisection a false certified bound.
            z_cert = (float(htz_rel) < -1e-9
                      and float(zres_rel) < 1e-6)
            x_cert = (float(ctx_rel) < -1e-9
                      and float(xres_rel) < 1e-6)
            if float(kap_rel) < 1e-12 and not (z_cert or x_cert):
                status = "failed"
            elif x_cert and not z_cert:
                status = "unbounded"
            else:
                # the dual-ray certificate, or an ambiguous collapse
                # with live kappa (HSD theory: kappa > 0 at the limit
                # excludes a finite optimum) -- the pre-existing label
                status = "infeasible"
        elif it >= max_iter:
            status = "max_iter"
        else:
            status = "failed"
        return ConeLPResult(x=xb, status=status, iterations=it,
                            gap=gap_f, pres=pres_f, dres=dres_f,
                            pobj=pobj_f, dims=dims_rec), False, \
            (np.asarray(fx), np.asarray(fs), np.asarray(fS),
             np.asarray(fz), np.asarray(fZ))

    import time as _time
    _t0 = _time.perf_counter()
    res, infra, wout = _attempt(step_frac, arrays_np)
    _t_first = _time.perf_counter() - _t0
    dims_rec["wall_attempt_s"] = _t_first
    dims_rec["retried"] = False
    if (warm_entry is not None and not infra
            and res.status not in _WARM_OK):
        # The warm start must never cost robustness: any non-OK outcome
        # on a warm-seeded dispatch falls back to the bit-exact
        # historical cold start (wlam = 0 reuses the same program) and
        # the cold result is preferred unless the warm one was strictly
        # better-ranked.  The stale entry is dropped so later re-solves
        # do not repeat the detour.
        with _WARM_LOCK:
            _WARM_CACHE.pop(fp, None)
        dims_rec["warm_start"] = False
        _t1 = _time.perf_counter()
        res_c, infra, wout_c = _attempt(step_frac, arrays_cold)
        _t_cold = _time.perf_counter() - _t1
        _rank0 = {"optimal": 0, "inaccurate": 1, "infeasible": 2,
                  "unbounded": 2, "max_iter": 3, "failed": 4}
        if _rank0.get(res.status, 4) < _rank0.get(res_c.status, 4):
            pass                       # keep the warm result
        else:
            res, wout = res_c, wout_c
            dims_rec["wall_attempt_s"] = _t_cold
    if res.status == "failed" and not infra and step_frac > 0.92:
        # A 0.99 fraction-to-boundary can wedge the iterate off-center
        # near the PSD boundary on generic (non-MLBLUE-shaped) cone
        # programs: the step then collapses while centrality cannot be
        # recovered (observed on random covering SDPs -- clean descent to
        # gap ~4e-3, then step -> 0; the same instances converge in ~12
        # iterations at 0.85).  Retry once conservatively: step_frac is a
        # traced scalar, so this reuses the SAME compiled program, and
        # MLBLUE production instances never return "failed" (stress
        # corpus + goldens gate on it), so their path is untouched.
        _t1 = _time.perf_counter()
        res2, _, wout2 = _attempt(0.85, arrays_cold)
        _t_second = _time.perf_counter() - _t1
        dims_rec["retried"] = True
        rank = {"optimal": 0, "inaccurate": 1, "infeasible": 2,
                "unbounded": 2, "max_iter": 3, "failed": 4}

        def _worst(r):
            # gap RELATIVE to the objective, like the status derivation
            # above -- the absolute gap otherwise swamps pres/dres on
            # large-objective instances and the tie-break picks the
            # point with worse feasibility
            rg = r.gap / max(1.0, abs(r.pobj)) if np.isfinite(r.pobj) \
                else r.gap
            return max(r.pres, r.dres, rg)

        if rank.get(res2.status, 4) < rank.get(res.status, 4) or (
                res2.status == res.status and _worst(res2) < _worst(res)):
            res = res2
            wout = wout2
            dims_rec["wall_attempt_s"] = _t_second
    # total solve wall (incl. trace/compile on a cold program + any
    # conservative retry); every attempt's result shares dims_rec, so
    # this reaches the certificate no matter which attempt won.
    # wall_attempt_s isolates the WINNING attempt's dispatch (still
    # includes trace/compile when that attempt was the cold one) so
    # flops accounting does not divide by retry time (bench.ipm_report).
    dims_rec["wall_s"] = _time.perf_counter() - _t0
    if (fp is not None and wout is not None and res.status in _WARM_OK
            and all(np.all(np.isfinite(a)) for a in wout)):
        with _WARM_LOCK:
            _WARM_CACHE[fp] = wout
            while len(_WARM_CACHE) > _WARM_CACHE_MAX:
                _WARM_CACHE.pop(next(iter(_WARM_CACHE)))
    return res
