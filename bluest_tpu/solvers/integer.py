"""Integer rounding of continuous sample allocations.

Fresh implementation of the reference's corner-search machinery
(misc.py:134-413): pick the ~1.2*N largest allocation entries, enumerate all
floor/ceil corners (2^LL of them), and select the best feasible corner by
batched evaluation.  The batched evaluation -- thousands of (M x M)
Hermitian pseudo-inverses -- is vmapped on device; everything else is cheap
host bookkeeping.

Documented divergence from the reference: in the multi-output search the
reference keeps the *union* of columns satisfying each output's
"model-0 coverage" constraint and reports infeasibility when no output
needs filtering (misc.py:257-264); we filter with the *intersection* and
keep all columns when no filtering is needed, which is the mathematically
intended constraint (every output needs e_n @ m >= 1).
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

_PINV_RCOND = 1.0e-10
_CHUNK = 8192
# Dispatch all corner-variance chunks asynchronously and fetch them in ONE
# jax.device_get (the solve-loop _pipelined_sumse pattern): a blocking
# per-chunk fetch pays a full device round trip each (chunks x outputs).
# BLUEST_TPU_CORNER_PIPELINE=0 restores the synchronous per-chunk fetch
# (the A/B knob used to validate the win; see CLAUDE.md).
_PIPELINE = os.environ.get("BLUEST_TPU_CORNER_PIPELINE", "1") != "0"


def feasible_integer_bounds(sol: np.ndarray, N: int, e: np.ndarray | None = None):
    """Floor/ceil bounds over the entries worth optimizing
    (reference get_feasible_integer_bounds, misc.py:141-167)."""
    sol = np.asarray(sol, dtype=float)
    L = len(sol)
    idx = np.argsort(sol)[-int(1.2 * N):]
    idx = np.array([i for i in idx if sol[i] > 1.0e-8], dtype=int)

    if e is not None:
        e = np.asarray(e, dtype=float)
        if np.sum(e > 0.99) == 0:
            val = 1.0 / np.sum(e) / 2
            while np.sum(e > val) == 0:
                val /= 2
        else:
            val = 0.99
        idx2 = np.where(e > val)[0]
        order = np.argsort(sol[e > val])[::-1]
        idx2 = idx2[order[:N]]
        idx = np.unique(np.concatenate([idx, idx2])).astype(int)

    lb = np.zeros(L, dtype=np.int64)
    ub = np.zeros(L, dtype=np.int64)
    lb[idx] = np.floor(sol[idx]).astype(np.int64)
    ub[idx] = np.ceil(sol[idx]).astype(np.int64)
    # entries already integral (floor == ceil) carry no search freedom;
    # keeping them would inflate 2^LL (and push sparse post-cleanup
    # solutions into the randomized-fallback regime) for nothing
    idx = idx[lb[idx] < ub[idx]]
    order = np.argsort(lb[idx])[::-1]
    idx = idx[order]
    return lb[idx], ub[idx], idx


def corner_matrix(lb: np.ndarray, ub: np.ndarray) -> np.ndarray:
    """All floor/ceil corners as columns: (LL, 2^LL)
    (reference unpackbits + fancy indexing, misc.py:169-175, 239-242).

    Built row-by-row in int32: the obvious broadcast
    ``(arange(2^LL)[:, None] >> arange(LL)) & 1`` materializes a
    (2^24, 24) int64 intermediate (~3.2 GB) at the permitted LL=24
    limit; per-row generation peaks at one (2^LL,) uint32 vector and
    the int32 result (sample bounds fit int32 by orders of magnitude)."""
    LL = len(lb)
    n = 1 << LL
    cols = np.arange(n, dtype=np.uint32)
    out = np.empty((LL, n), dtype=np.int32)
    for j in range(LL):
        bit = (cols >> np.uint32(j)) & np.uint32(1)
        out[j] = np.where(bit.astype(bool), np.int32(ub[j]), np.int32(lb[j]))
    return out


@jax.jit
def _chunk_var00(P):
    w, V = jnp.linalg.eigh(P)
    cutoff = _PINV_RCOND * jnp.max(jnp.abs(w), axis=-1, keepdims=True)
    inv_w = jnp.where(jnp.abs(w) > cutoff, 1.0 / w, 0.0)
    v0 = V[:, 0, :]  # first row of V
    return jnp.sum(v0 * inv_w * v0, axis=-1)


@jax.jit
def _chunk_corner_var(basephi, psi_idx, ms_chunk):
    """Fused corner-PHI assembly + Hermitian pinv[0,0]:
    basephi (M^2,), psi_idx (M^2, LL), ms_chunk (LL, C) -> (C,)."""
    Msq = basephi.shape[0]
    M = int(round(np.sqrt(Msq)))
    phis = (basephi[:, None] + psi_idx @ ms_chunk).T.reshape(-1, M, M)
    return _chunk_var00(phis)


def _corner_var_dispatch(basephi: np.ndarray, psi_idx: np.ndarray,
                         ms: np.ndarray):
    """Dispatch the corner-variance chunks without blocking.

    Returns ``(pending, widths)`` where ``pending`` is a list of device
    arrays (one per chunk, still computing) and ``widths`` the valid
    column count of each.  Callers gather every pending chunk -- across
    outputs too -- in ONE ``jax.device_get`` so the link latency is paid
    once, not once per chunk (with ``_PIPELINE`` off each chunk is
    fetched synchronously, the pre-pipelining behavior).

    Shape stabilization: EVERY chunk is padded to _CHUNK columns and LL
    to a multiple of 4 zero rows (zero columns of psi_idx contribute
    nothing to the PHI assembly), so the program key is
    (M^2, ceil4(LL), _CHUNK) -- a handful of programs instead of one
    compile round-trip per post-filter corner count."""
    LL, B = ms.shape
    LLp = max(4, 4 * -(-LL // 4))
    pidx_np = psi_idx
    if LLp != LL:
        pidx_np = np.concatenate(
            [psi_idx, np.zeros((psi_idx.shape[0], LLp - LL))], axis=1)
    bphi = jnp.asarray(basephi)
    pidx = jnp.asarray(pidx_np)
    pending, widths = [], []
    for s in range(0, B, _CHUNK):
        chunk = ms[:, s:s + _CHUNK].astype(np.float64)
        nb = chunk.shape[1]
        if nb < _CHUNK or LLp != LL:
            buf = np.zeros((LLp, _CHUNK))
            buf[:LL, :nb] = chunk
            chunk = buf
        dev = _chunk_corner_var(bphi, pidx, jnp.asarray(chunk))
        pending.append(dev if _PIPELINE else np.asarray(dev))
        widths.append(nb)
    return pending, widths


def _corner_var_assemble(host_chunks, widths) -> np.ndarray:
    if not widths:
        return np.zeros(0)
    return np.concatenate([np.asarray(h)[:nb]
                           for h, nb in zip(host_chunks, widths)])


def _corner_variances(basephi: np.ndarray, psi_idx: np.ndarray,
                      ms: np.ndarray) -> np.ndarray:
    """Variances of all corner candidates, assembled and inverted on
    device in fixed-size chunks (basephi + psi_idx @ ms never materializes
    on the host)."""
    pending, widths = _corner_var_dispatch(basephi, psi_idx, ms)
    return _corner_var_assemble(jax.device_get(pending), widths)


def best_integer_generic(sol, obj: Callable, constr: Callable, N: int,
                         e: np.ndarray | None = None):
    """Generic corner search with Python-callable objective/constraint
    (reference best_closest_integer_solution, misc.py:384-413).  Used by the
    MLMC/MFMC closed forms where LL is tiny."""
    sol = np.asarray(sol, dtype=float)
    lb, ub, idx = feasible_integer_bounds(sol, N, e=e)
    LL = len(idx)
    if LL > 24:
        raise ValueError("Too many dimensions to brute-force it")

    ms = corner_matrix(lb, ub)  # (LL, 2^LL)
    val = np.round(sol).astype(np.int64)
    best_fval = np.inf
    best = None
    for i in range(ms.shape[1]):
        val[idx] = ms[:, i]
        if constr(val):
            f = obj(val)
            if f < best_fval:
                best_fval = f
                best = val.copy()
    if best is None:
        return None, np.inf
    return best, best_fval


def _apply_max_sample_filter(ms, idx, baseval, max_samples_info):
    """Columns surviving the per-model max-sample caps
    (reference misc.py:267-276, 344-353). Returns ms or None."""
    ES, rhs = max_samples_info
    if len(ES) == 0:
        return ms
    base = [ees @ baseval for ees in ES]
    if any(b > r for b, r in zip(base, rhs)):
        return None
    checks = [b + np.asarray(ees)[idx] @ ms for b, ees in zip(base, ES)]
    mask = np.all([c <= r for c, r in zip(checks, rhs)], axis=0)
    keep = np.where(mask)[0]
    if len(keep) == 0:
        return None
    return ms[:, keep]


def best_integer_blue(sol, psi: np.ndarray, w: np.ndarray, e: np.ndarray,
                      budget: Optional[float] = None,
                      eps: Optional[float] = None,
                      max_samples_info=((), ())):
    """Single-output BLUE corner search
    (reference best_closest_integer_solution_BLUE, misc.py:313-382)."""
    sol = np.asarray(sol, dtype=float)
    N = int(round(np.sqrt(psi.shape[0])))
    lb, ub, idx = feasible_integer_bounds(sol, N, e=e)
    LL = len(idx)
    if LL > 24:
        raise ValueError("Too many dimensions to brute-force it")

    ms = corner_matrix(lb, ub)
    val = np.round(sol).astype(np.int64)
    baseval = val.copy(); baseval[idx] = 0
    basephi = psi @ baseval
    basecost = w @ baseval
    basee = e @ baseval

    if basee < 1:
        keep = np.where(basee + e[idx] @ ms >= 1)[0]
        if len(keep) == 0:
            return None, np.inf
        ms = ms[:, keep]

    ms = _apply_max_sample_filter(ms, idx, baseval, max_samples_info)
    if ms is None:
        return None, np.inf

    if budget is not None and basecost > budget:
        return None, np.inf

    costs = basecost + w[idx] @ ms
    if budget is not None:
        keep = np.where(costs <= 1.0001 * budget)[0]
        if len(keep) == 0:
            return None, np.inf
        ms = ms[:, keep][:, ::-1]
    else:
        ms = ms[:, np.argsort(costs)[::-1]]

    if ms.size == 0:
        return None, np.inf

    Vs = _corner_variances(basephi, psi[:, idx], ms)

    if budget is not None:
        i = int(np.argmin(Vs))
    else:
        ok = np.where(Vs <= 1.0001 * eps ** 2)[0]
        if len(ok) == 0:
            return None, np.inf
        i = int(ok[-1])  # columns are cost-descending: last feasible = cheapest

    val[idx] = ms[:, i]
    return val, float(Vs[i])


def _batch_variances_multi(vals, psis, mappings):
    """Per-output variances of a batch of full integer allocations:
    vals (L, B) -> list of (B,) arrays (pinv(PHI_n)[0,0]).  Batches are
    padded to a fixed width so the jitted eigh kernel compiles once per
    matrix size instead of once per (shrinking) greedy-wave width."""
    B = vals.shape[1]
    pad = 32 * ((B + 31) // 32)
    pending = []
    for n in range(len(mappings)):
        Phi = psis[n] @ vals[mappings[n], :].astype(np.float64)  # (M^2, B)
        M = int(round(np.sqrt(psis[n].shape[0])))
        phis = Phi.T.reshape(-1, M, M)
        if B < pad:
            phis = np.concatenate(
                [phis, np.broadcast_to(np.eye(M), (pad - B, M, M))], axis=0)
        dev = _chunk_var00(jnp.asarray(phis))
        pending.append(dev if _PIPELINE else np.asarray(dev))
    # one gather for all outputs (see _corner_var_dispatch)
    return [np.asarray(h)[:B] for h in jax.device_get(pending)]


def _feasible_multi(vals, psis, w, e, mappings, budget, eps,
                    max_samples_info, slack=1.0001):
    """(feasible mask, max-variance, cost) for a batch of allocations
    (L, B), enforcing coverage, caps, and the budget/eps constraint."""
    No = len(mappings)
    costs = w @ vals
    ok = np.ones(vals.shape[1], dtype=bool)
    for n in range(No):
        ok &= e[mappings[n]] @ vals[mappings[n], :] >= 1.0
    ES, rhs = max_samples_info
    for ees, rr in zip(ES, rhs):
        ok &= np.asarray(ees) @ vals <= rr
    Vs = _batch_variances_multi(vals, psis, mappings)
    V_max = np.max(np.stack(Vs), axis=0)
    if budget is not None:
        ok &= costs <= slack * budget
    else:
        epsa = np.asarray(eps, dtype=float)
        for n in range(No):
            ok &= Vs[n] <= slack * epsa[n] ** 2
    return ok, V_max, costs


def _greedy_round_multi(sol, psis, w, e, mappings, budget, eps,
                        max_samples_info):
    """Deterministic greedy rounding for LL past the brute-force limit.

    eps mode: start from the always-feasible all-ceil point (the variance
    is monotone decreasing in m, so V(ceil(m*)) <= V(m*) = eps^2) and
    greedily floor fractional entries in order of cost saving while every
    output stays within tolerance.  budget mode: start from the
    cost-feasible all-floor point and greedily ceil the entry with the
    best max-variance improvement while the budget holds.  Each wave
    evaluates all candidate single flips in one batched device call
    (a wave is ~#fractional small eigh pinvs per output -- microseconds,
    vs the 250 x 2^15 corner sweeps of a randomized search).
    """
    sol = np.maximum(np.asarray(sol, dtype=float), 0.0)
    if sol.max() > 0:  # drop interior-point tail junk (same 1e-8 cutoff
        sol[sol < 1e-8 * sol.max()] = 0.0  # as feasible_integer_bounds)
    floors = np.floor(sol).astype(np.int64)
    ceils = np.ceil(sol).astype(np.int64)
    frac = np.where(floors < ceils)[0]
    if budget is None:
        val = ceils.copy()
        target = floors
        # On ill-conditioned instances (cond(PHI) ~ 1e12) the variance is
        # only defined to ~cond * 1e-16 relative, which can exceed the
        # 1.0001 feasibility slack even at the exact continuous optimum.
        # Self-repair with a tiny inflation of the continuous point -- far
        # cheaper in solution quality than the 1.001x tolerance ladder.
        for beta in (1.0, 1.0002, 1.001, 1.01):
            val = np.ceil(beta * sol).astype(np.int64)
            ok0, _, _ = _feasible_multi(val[:, None].astype(np.float64),
                                        psis, w, e, mappings, budget, eps,
                                        max_samples_info)
            if ok0[0]:
                break
    else:
        val = floors.copy()
        target = ceils
        # restore per-output coverage broken by flooring: ceil the
        # cheapest fractional model-0 group per uncovered output
        for n in range(len(mappings)):
            en = e[mappings[n]]
            while en @ val[mappings[n]] < 1.0:
                cand = [i for i in frac
                        if val[i] < ceils[i] and e[i] > 0
                        and int(i) in set(int(g) for g in mappings[n])]
                if not cand:
                    break
                i = min(cand, key=lambda i: w[i])
                val[i] = ceils[i]
    ok0, V0, cost0 = _feasible_multi(val[:, None].astype(np.float64), psis,
                                     w, e, mappings, budget, eps,
                                     max_samples_info)
    if not ok0[0]:
        return None, np.inf
    free = [int(i) for i in frac if val[i] != target[i]]
    while free:
        B = len(free)
        vals = np.repeat(val[:, None], B, axis=1).astype(np.float64)
        for j, i in enumerate(free):
            vals[i, j] = target[i]
        ok, V_max, costs = _feasible_multi(vals, psis, w, e, mappings,
                                           budget, eps, max_samples_info)
        cand = [j for j in range(B) if ok[j]]
        if not cand:
            break
        if budget is None:
            # flip the feasible floor with the largest cost saving
            j = max(cand, key=lambda j: w[free[j]])
        else:
            # flip the ceil that most reduces the max variance in budget
            j = min(cand, key=lambda j: V_max[j])
        val[free[j]] = target[free[j]]
        free.pop(j)

    ok, V_max, costs = _feasible_multi(val[:, None].astype(np.float64), psis,
                                       w, e, mappings, budget, eps,
                                       max_samples_info)
    if not ok[0]:
        return None, np.inf
    return val, float(V_max[0])


def best_integer_blue_multi(sol, psis: Sequence[np.ndarray], w: np.ndarray,
                            e: np.ndarray, mappings: Sequence[np.ndarray],
                            budget: Optional[float] = None,
                            eps=None, max_samples_info=((), ()),
                            rng: np.random.Generator | None = None,
                            ll_max: int = 15, n_trials: int = 64):
    """Multi-output BLUE corner search
    (reference best_closest_integer_solution_BLUE_multi, misc.py:177-311).

    Documented divergence: past the 2^ll_max brute-force limit the
    reference runs 250 randomized corner sweeps (misc.py:216-226) -- each a
    full 2^15-corner batched-pinv pass, minutes of work when most trials
    are infeasible.  We instead do a deterministic greedy round (monotone
    start corner + batched single-flip waves), then polish the ll_max
    most significant entries with the exact corner search around the
    greedy point; the randomized sweep is kept only as a last resort."""
    sol = np.asarray(sol, dtype=float)
    No = len(mappings)
    N = int(round(np.sqrt(psis[0].shape[0])))

    lb_f, ub_f, idx_f = feasible_integer_bounds(sol, N, e=e)
    LL = len(idx_f)

    if LL <= ll_max:
        return _multi_helper(sol, psis, w, e, mappings, budget, eps,
                             lb_f, ub_f, idx_f, max_samples_info)

    g_val, g_fval = _greedy_round_multi(sol, psis, w, e, mappings, budget,
                                        eps, max_samples_info)
    if g_val is not None:
        # polish: exact corner search over the ll_max largest entries,
        # everything else pinned at the greedy integers
        order = np.argsort(sol[idx_f])[::-1]
        top = np.sort(order[:ll_max])
        r_sol = g_val.astype(float)
        p_val, p_fval = _multi_helper(
            r_sol, psis, w, e, mappings, budget, eps,
            lb_f[top], ub_f[top], idx_f[top], max_samples_info)
        if p_val is not None:
            return p_val, p_fval
        return g_val, g_fval

    if rng is None:
        rng = np.random.default_rng(0)
    for _ in range(n_trials):
        perm = rng.permutation(LL)
        bf, rc = perm[:ll_max], perm[ll_max:]
        r_sol = sol.copy()
        pick = rng.integers(2, size=len(rc))
        bnds = np.vstack([lb_f[rc], ub_f[rc]])
        r_sol[idx_f[rc]] = bnds[pick, np.arange(len(rc))]
        best_val, best_fval = _multi_helper(
            r_sol, psis, w, e, mappings, budget, eps,
            lb_f[bf], ub_f[bf], idx_f[bf], max_samples_info)
        if best_val is not None:
            return best_val, best_fval
    return None, np.inf


def _multi_helper(sol, psis, w, e, mappings, budget, eps, lb, ub, idx,
                  max_samples_info):
    """(reference ..._BLUE_multi_helper, misc.py:228-311)."""
    No = len(mappings)
    N = int(round(np.sqrt(psis[0].shape[0])))
    ms = corner_matrix(lb, ub)
    val = np.round(sol).astype(np.int64)
    baseval = val.copy(); baseval[idx] = 0
    basephis = [psis[n] @ baseval[mappings[n]] for n in range(No)]
    basecost = w @ baseval
    basees = [e[mappings[n]] @ baseval[mappings[n]] for n in range(No)]

    # positions within idx belonging to output n, and the matching local
    # (psi_n column) indices, both in idx order (reference misc.py:253-255)
    redmaps, idxs = [], []
    for n in range(No):
        mset = set(int(i) for i in mappings[n])
        red = [i for i in range(len(idx)) if int(idx[i]) in mset]
        loc = [int(np.where(mappings[n] == int(idx[i]))[0][0]) for i in red]
        redmaps.append(np.array(red, dtype=int))
        idxs.append(np.array(loc, dtype=int))

    if budget is not None and basecost > budget:
        return None, np.inf

    # Corner feasibility filter (budget + per-output coverage + caps).
    # One native pass over the 2^LL corners when the C library is built
    # (bit order matches corner_matrix); numpy fallback otherwise.
    ES, rhs = max_samples_info
    if any(ees @ baseval > rr for ees, rr in zip(ES, rhs)):
        return None, np.inf
    keep_mask = None
    if lb.size:
        from .. import _native
        e_rows_l, e_base_l = [], []
        for n in range(No):
            if basees[n] < 1:
                row = np.zeros(len(idx))
                row[redmaps[n]] = e[idx][redmaps[n]]
                e_rows_l.append(row)
                e_base_l.append(basees[n])
        keep_mask = _native.corner_filter(
            lb, ub, basecost, w[idx],
            budget if budget is not None else 0.0,
            e_rows_l, e_base_l,
            [np.asarray(ees)[idx] for ees in ES],
            [rr - ees @ baseval for ees, rr in zip(ES, rhs)])
    if keep_mask is not None:
        ms = ms[:, keep_mask]
        if ms.shape[1] == 0:
            return None, np.inf
        costs = basecost + w[idx] @ ms
        if budget is None:
            ms = ms[:, np.argsort(costs)[::-1]]
    else:
        mask = np.ones(ms.shape[1], dtype=bool)
        for n in range(No):
            if basees[n] < 1:
                mask &= (basees[n]
                         + e[idx][redmaps[n]] @ ms[redmaps[n], :]) >= 1
        keep = np.where(mask)[0]
        if len(keep) == 0:
            return None, np.inf
        ms = ms[:, keep]

        ms = _apply_max_sample_filter(ms, idx, baseval, max_samples_info)
        if ms is None:
            return None, np.inf

        costs = basecost + w[idx] @ ms
        if budget is not None:
            keep = np.where(costs <= 1.0001 * budget)[0]
            if len(keep) == 0:
                return None, np.inf
            ms = ms[:, keep][:, ::-1]
        else:
            ms = ms[:, np.argsort(costs)[::-1]]
    if ms.size == 0:
        return None, np.inf

    # dispatch every output's chunks first, then ONE gather for all of
    # them (per-output blocking fetches serialize link round trips)
    pend = [_corner_var_dispatch(basephis[n], psis[n][:, idxs[n]],
                                 ms[redmaps[n], :]) for n in range(No)]
    host = jax.device_get([p[0] for p in pend])
    Vs = [_corner_var_assemble(h, p[1]) for h, p in zip(host, pend)]
    V_max = np.max(np.stack(Vs), axis=0)

    if budget is not None:
        i = int(np.argmin(V_max))
    else:
        eps = np.asarray(eps, dtype=float)
        ok = np.all(np.stack([Vs[n] <= 1.0001 * eps[n] ** 2
                              for n in range(No)]), axis=0)
        ok = np.where(ok)[0]
        if len(ok) == 0:
            return None, np.inf
        i = int(ok[-1])

    val[idx] = ms[:, i]
    return val, float(V_max[i])
