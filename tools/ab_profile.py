"""Same-window A/B profiling for the allocation (IPM) hot path.

Standalone microbenchmarks do NOT predict costs inside the fused IPM
program, and host throughput can swing between measurement windows (a
kron reformulation once looked 2.6x faster in one window and 13% slower
in a controlled one).  This harness
makes perf experiments decidable anyway: it interleaves the two variants
within one window (ABBA blocks, cancelling linear drift), runs each rep
in a fresh subprocess (import-time env knobs like BLUEST_TPU_GONDZIO and
BLUEST_TPU_WOOD_PAD are baked into the traced program), and reports
PAIRED ratios on the warm-program solve -- the only comparison that has
been reproducible on this hardware.

Usage (variant env as comma-separated KEY=VAL):

    python tools/ab_profile.py --a "" --b "BLUEST_TPU_GONDZIO=1" \
        --k 5 --pairs 3

Per child rep: load the Hodgkin-Huxley golden npz (12 models, 5
outputs, the paper study of arXiv 2301.07831), setup_solver(K, eps) once
cold (pays trace+compile), then re-solve with a non-uniformly perturbed
eps -- the perturbation defeats the budget-ray cache so the full IPM
runs again, on the already-compiled program.  The warm wall and the
per-IPM-iteration wall (warm wall / certificate iterations) are the A/B
metrics; cold wall is reported for context only.

Reference for the methodology gap this fills: the reference repo times
its solvers with single uncontrolled runs (bluest_NS.py:124-140).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HH_NPZ = ("/root/reference/examples/paper_examples/hodgkin-huxley/"
          "model_graph_data.npz")
HH_EPS = [0.00591726, 0.00834864, 0.01971628, 0.03892175, 0.00101537]
# non-uniform: a common factor would keep the eps ray (and its cached
# allocation) unchanged under the homogeneity reduction
PERTURB = [1.07, 1.11, 1.05, 1.13, 1.09]


def _child(k: int) -> None:
    # running as tools/ab_profile.py puts tools/ (not the repo root) on
    # sys.path; the package lives one level up
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # the child runs on the devices JAX gives it: the allocation runs on
    # the host CPU device by default, and BLUEST_TPU_ALLOC_DEVICE=default
    # as a variant env measures it on the accelerator
    import bluest_tpu.config  # noqa: F401  (x64 + cache, must be first)
    import numpy as np
    from bluest_tpu import BLUEProblem

    problem = BLUEProblem(12, n_outputs=5, datafile=HH_NPZ, verbose=False)

    t0 = time.perf_counter()
    out = problem.setup_solver(K=k, eps=HH_EPS)
    cold_s = time.perf_counter() - t0
    it_cold = sum(c.get("iterations", 0) for c in problem.MOSAP.certificates)

    eps2 = [e * p for e, p in zip(HH_EPS, PERTURB)]
    t0 = time.perf_counter()
    out2 = problem.setup_solver(K=k, eps=eps2)
    warm_s = time.perf_counter() - t0
    it_warm = sum(c.get("iterations", 0) for c in problem.MOSAP.certificates)

    print(json.dumps({
        "cold_s": round(cold_s, 4), "warm_s": round(warm_s, 4),
        "iters_cold": int(it_cold), "iters_warm": int(it_warm),
        "per_iter_ms": round(1e3 * warm_s / max(it_warm, 1), 3),
        "cost": float(out["total_cost"]), "cost2": float(out2["total_cost"]),
        "fallbacks": int(problem.MOSAP.n_nlp_fallbacks),
        "L": int(np.size(out["samples"])),
    }))


def _parse_env(spec: str) -> dict:
    env = {}
    for kv in filter(None, (s.strip() for s in spec.split(","))):
        key, _, val = kv.partition("=")
        env[key] = val
    return env


def _run_variant(name: str, env_spec: str, k: int,
                 child_timeout: float) -> dict:
    env = dict(os.environ)
    env.update(_parse_env(env_spec))
    cmd = [sys.executable, os.path.abspath(__file__),
           "--child", "--k", str(k)]
    try:
        r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=child_timeout,
                           cwd=os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    except subprocess.TimeoutExpired:
        raise SystemExit(
            "variant %s child exceeded --child-timeout %.0fs -- a "
            "stalled variant would otherwise eat the whole measurement "
            "window" % (name, child_timeout))
    line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    try:
        rec = json.loads(line)
    except (json.JSONDecodeError, IndexError):
        sys.stderr.write(r.stdout + r.stderr)
        raise SystemExit("variant %s child failed (rc=%d)" % (name, r.returncode))
    rec["variant"] = name
    print("  %s: warm %.2fs  (%d its, %.1f ms/it; cold %.1fs, "
          "cost %.1f, fallbacks %d)"
          % (name, rec["warm_s"], rec["iters_warm"], rec["per_iter_ms"],
             rec["cold_s"], rec["cost"], rec["fallbacks"]))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--a", default="", help="variant A env, KEY=VAL[,KEY=VAL]")
    ap.add_argument("--b", default="", help="variant B env")
    ap.add_argument("--k", type=int, default=5,
                    help="max coupling size (5: L~800 mid-size; 7: L=3301 "
                         "the paper study, ~90s/rep)")
    ap.add_argument("--pairs", type=int, default=3,
                    help="ABBA block count (2 runs/variant/block)")
    ap.add_argument("--child-timeout", type=float, default=900.0,
                    help="per-rep wall cap in seconds")
    ap.add_argument("--warmup", action="store_true",
                    help="run one discarded rep per variant first: a "
                         "variant whose env changes the traced program "
                         "pays the full compile set on its first rep "
                         "(minutes when the compile cache is cold), "
                         "which must not land inside a measured block")
    args = ap.parse_args()

    if args.child:
        _child(args.k)
        return

    if not os.path.exists(HH_NPZ):
        raise SystemExit("reference HH npz not mounted: " + HH_NPZ)

    print("A/B on HH golden, K=%d, %d ABBA blocks (A=%r vs B=%r)"
          % (args.k, args.pairs, args.a, args.b))
    if args.warmup:
        for name, spec in (("A", args.a), ("B", args.b)):
            print("warmup %s (discarded; compiles cached on disk)" % name)
            _run_variant(name, spec, args.k, 4 * args.child_timeout)
    recs_a, recs_b = [], []
    for blk in range(args.pairs):
        # ABBA: linear window drift cancels within each block
        order = (("A", args.a, recs_a), ("B", args.b, recs_b),
                 ("B", args.b, recs_b), ("A", args.a, recs_a))
        print("block %d/%d" % (blk + 1, args.pairs))
        for name, spec, sink in order:
            sink.append(_run_variant(name, spec, args.k,
                                     args.child_timeout))

    import statistics as st
    for metric in ("warm_s", "per_iter_ms"):
        va = sorted(r[metric] for r in recs_a)
        vb = sorted(r[metric] for r in recs_b)
        med_a, med_b = st.median(va), st.median(vb)
        # paired ratios per block position: element-wise after sorting
        # within variant is NOT paired; use block medians instead
        block_ratio = []
        for blk in range(args.pairs):
            a_blk = [recs_a[2 * blk][metric], recs_a[2 * blk + 1][metric]]
            b_blk = [recs_b[2 * blk][metric], recs_b[2 * blk + 1][metric]]
            block_ratio.append(st.median(b_blk) / st.median(a_blk))
        print("%-12s A median %.3f  B median %.3f  B/A per-block %s "
              "(median %.3f)"
              % (metric, med_a, med_b,
                 [round(r, 3) for r in block_ratio],
                 st.median(block_ratio)))
    ic = [r["iters_warm"] for r in recs_a], [r["iters_warm"] for r in recs_b]
    print("iters_warm   A %s  B %s" % ic)
    print("verdict: B/A < 0.95 across ALL blocks = win; straddling 1.0 = "
          "wash (window noise); see CLAUDE.md on unreproducible speedups")


if __name__ == "__main__":
    main()
