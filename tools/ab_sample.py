"""Same-window A/B profiling for the SAMPLING phase on the device.

Counterpart of tools/ab_profile.py (which A/Bs the allocation IPM on the
host backend): this harness A/Bs the estimation/sampling hot path -- the
vmapped per-model kernels + group combiners -- ON THE DEFAULT DEVICE,
where throughput knobs like ``device_batch_size`` actually live.  Single
uncontrolled runs drift between windows, so variants are interleaved in
ABBA blocks with each rep in a fresh subprocess (one process on the
card at a time; the parent stays off JAX) and PAIRED per-block ratios
reported.

Usage (variants are device_batch_size values, optionally with extra env):

    python tools/ab_sample.py --a 16384 --b 8192 --pairs 3
    python tools/ab_sample.py --a 16384 --b 16384 \
        --env-b "BLUEST_TPU_SOME_KNOB=1" --pairs 3

Per child rep: build the bench.py flagship problem (10-model diffusion
hierarchy, 3 outputs, f32 models) from the cached covariance graph
(run ``python bench.py`` once first to create it), warm the sampling
kernels, solve the K=4 allocation ONCE at a fixed budget (identical
across variants -- deterministic from the cached graph), then time
``--reps`` estimation runs of ~1e6 coupled evaluations on the already
compiled programs.  The metric is the best-of-reps sampling wall
(identical device programs, so within-child spread is window noise).
Each record names the device it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

FIXED_BUDGET = 1.0e8  # ~2e7 coupled evals on the bench hierarchy (~20x
                      # the bench workload: sampling walls of a few
                      # seconds give the ABBA blocks usable signal over
                      # ~10ms dispatch noise; identical allocation
                      # across all variants by construction)


def _child(batch: int, reps: int, k: int, budget: float) -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bluest_tpu.config  # noqa: F401  (x64 + cache first)

    import jax
    import jax.numpy as jnp
    import bench  # repo-root bench.py: the flagship config

    cachefile = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        ".bench_graph_%s_%d.npz" % (
            "x".join(str(g) for g in bench.GRIDS), bench.PILOT))
    if not os.path.exists(cachefile):
        sys.stderr.write("bench graph cache missing (%s); run "
                         "`python bench.py` once first\n" % cachefile)
        raise SystemExit(4)

    from bluest_tpu.models.diffusion import DiffusionProblem
    problem = DiffusionProblem(
        datafile=cachefile, grids=bench.GRIDS, n_kl=bench.N_KL,
        sigma=bench.SIGMA, nu=bench.NU, multi_output=True, verbose=False,
        device_batch_size=batch, dtype=jnp.float32)
    M = len(bench.GRIDS)
    for l in range(M):
        problem.blue_fn([l], 1, verbose=False)
    for kk in range(2, min(M, k) + 1):
        problem.blue_fn(list(range(kk)), 1, verbose=False)
    problem.setup_solver(K=k, budget=budget)

    walls = []
    mus = errs = None
    for _ in range(reps):
        t0 = time.perf_counter()
        m, e, _cost = problem.solve(K=k, budget=budget)
        walls.append(time.perf_counter() - t0)
        if mus is None:
            mus, errs = m, e
    n_evals = bench.total_evaluations(problem)
    dev = jax.devices()[0]
    print(json.dumps({
        "sample_s": round(min(walls), 4),
        "walls_s": [round(w, 4) for w in walls],
        "n_evals": n_evals,
        "evals_per_s": round(n_evals / max(min(walls), 1e-9)),
        "batch": batch,
        "device": "%s:%s" % (dev.platform, dev.device_kind),
    }))


def _run_variant(name: str, batch: int, env_spec: str, reps: int, k: int,
                 child_timeout: float, budget: float) -> dict:
    env = dict(os.environ)
    for kv in filter(None, (s.strip() for s in env_spec.split(","))):
        key, _, val = kv.partition("=")
        env[key] = val
    cmd = [sys.executable, os.path.abspath(__file__), "--child",
           "--batch", str(batch), "--reps", str(reps), "--k", str(k),
           "--budget", str(budget)]
    try:
        r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=child_timeout,
                           cwd=os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    except subprocess.TimeoutExpired:
        raise SystemExit("variant %s child exceeded --child-timeout %.0fs"
                         % (name, child_timeout))
    line = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    try:
        rec = json.loads(line)
    except (json.JSONDecodeError, IndexError):
        sys.stderr.write(r.stdout + r.stderr)
        raise SystemExit("variant %s child failed (rc=%d)"
                         % (name, r.returncode))
    rec["variant"] = name
    print("  %s: sample %.3fs  (reps %s; %.2fM evals/s on %s)"
          % (name, rec["sample_s"], rec["walls_s"],
             rec["evals_per_s"] / 1e6, rec["device"]))
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--a", type=int, default=16384,
                    help="variant A device_batch_size")
    ap.add_argument("--b", type=int, default=8192,
                    help="variant B device_batch_size")
    ap.add_argument("--env-a", default="", help="extra env for A, KEY=VAL[,..]")
    ap.add_argument("--env-b", default="", help="extra env for B")
    ap.add_argument("--batch", type=int, default=16384, help=argparse.SUPPRESS)
    ap.add_argument("--budget", type=float, default=FIXED_BUDGET,
                    help="allocation budget per child (default ~2e7 evals; "
                         "use ~6e6 for the bench's overhead-bound 1.2M-eval "
                         "workload when A/Bing dispatch-path changes)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed estimation runs per child (best-of)")
    ap.add_argument("--k", type=int, default=4, help="coupling order")
    ap.add_argument("--pairs", type=int, default=3, help="ABBA block count")
    ap.add_argument("--child-timeout", type=float, default=1200.0)
    ap.add_argument("--warmup", action="store_true",
                    help="one discarded rep per variant first (fills the "
                         "persistent compile cache for new batch shapes)")
    args = ap.parse_args()

    if args.child:
        _child(args.batch, args.reps, args.k, args.budget)
        return

    print("sampling A/B on the bench flagship, K=%d, %d ABBA blocks "
          "(A=batch %d%s vs B=batch %d%s)"
          % (args.k, args.pairs, args.a,
             " +" + args.env_a if args.env_a else "",
             args.b, " +" + args.env_b if args.env_b else ""))
    if args.warmup:
        for name, batch, spec in (("A", args.a, args.env_a),
                                  ("B", args.b, args.env_b)):
            print("warmup %s (discarded; compiles cached on disk)" % name)
            _run_variant(name, batch, spec, 1, args.k,
                         4 * args.child_timeout, args.budget)
    recs_a, recs_b = [], []
    for blk in range(args.pairs):
        order = (("A", args.a, args.env_a, recs_a),
                 ("B", args.b, args.env_b, recs_b),
                 ("B", args.b, args.env_b, recs_b),
                 ("A", args.a, args.env_a, recs_a))
        print("block %d/%d" % (blk + 1, args.pairs))
        for name, batch, spec, sink in order:
            sink.append(_run_variant(name, batch, spec, args.reps, args.k,
                                     args.child_timeout, args.budget))

    import statistics as st
    med_a = st.median(r["sample_s"] for r in recs_a)
    med_b = st.median(r["sample_s"] for r in recs_b)
    block_ratio = []
    for blk in range(args.pairs):
        a_blk = [recs_a[2 * blk]["sample_s"], recs_a[2 * blk + 1]["sample_s"]]
        b_blk = [recs_b[2 * blk]["sample_s"], recs_b[2 * blk + 1]["sample_s"]]
        block_ratio.append(st.median(b_blk) / st.median(a_blk))
    print("sample_s     A median %.3f  B median %.3f  B/A per-block %s "
          "(median %.3f)"
          % (med_a, med_b, [round(r, 3) for r in block_ratio],
             st.median(block_ratio)))
    print("verdict: B/A < 0.95 across ALL blocks = win; straddling 1.0 = "
          "wash (window noise)")


if __name__ == "__main__":
    main()
