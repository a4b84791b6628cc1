"""A/B of the diffusion model's fused Triton kernel against the plain path.

``DiffusionProblem`` evaluates f32 models on a GPU with the Pallas-Triton
kernel of ``bluest_tpu/ops/triton_diffusion.py``; ``PlainPath`` below
leaves the engine its vmapped plain path, which XLA compiles (cyclic
reduction).  This script measures both in one process, so the finding in
PERF.md can be repeated.

    python tools/triton_diffusion_ab.py [--grids 1024 256 64] [--calls 20]
        [--rounds 10] [--out chiprun_out/triton_ab]
    python tools/triton_diffusion_ab.py --accuracy-only   # compile + check

On one GPU, at the bench deployment (``bench.py``):
  1. accuracy: each fidelity through the engine's sweep, XLA and Triton,
     against the f64 numpy/scipy reference (median and max relative error);
  2. device time: one fidelity's sweep at the bench batch, ``--calls``
     calls under ``jax.profiler``, busy time (the union of the device
     stream events) per call and its HBM roofline share by
     ``bench.bytes_per_sample``;
  3. end to end: the bench allocation (pilot 4096, K=4, ~1e6 coupled
     samples) shared by both problems, ``--rounds`` ABBA rounds of
     ``solve`` after 3 warm-up solves each; medians, the paired ratio
     with its 95% bootstrap interval, and each arm's device busy time
     per solve from a trace of ``--calls`` solves.
The last line of stdout is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plain_path_class():
    """DiffusionProblem without its batched model: the engine vmaps
    evaluate_model_jax, the path XLA compiles."""
    from bluest_tpu.models.diffusion import DiffusionProblem

    class PlainPath(DiffusionProblem):
        evaluate_model_jax_batched = None

    return PlainPath


# ---------------------------- trace reduction --------------------------- #

def union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_busy(trace_dir, plane_prefix="/device:GPU:0"):
    """(busy ns, {event name: summed ns}) over the stream lines of the
    first device's plane in the ``jax.profiler`` trace under trace_dir."""
    from jax.profiler import ProfileData
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise FileNotFoundError("no .xplane.pb under %s" % trace_dir)
    pd = ProfileData.from_file(paths[0])
    ivs, per_name = [], {}
    for plane in pd.planes:
        if not plane.name.startswith(plane_prefix):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                start, dur = int(ev.start_ns), int(ev.duration_ns)
                ivs.append((start, start + dur))
                per_name[ev.name] = per_name.get(ev.name, 0) + dur
    return union_ns(ivs), per_name


def paired_ratio(b, a, n_boot=2000, seed=0):
    """Median of the paired ratios b[i]/a[i] and its 95% bootstrap
    interval."""
    r = np.asarray(b, float) / np.asarray(a, float)
    rng = np.random.default_rng(seed)
    boots = np.median(rng.choice(r, (n_boot, len(r))), axis=1)
    lo, hi = np.percentile(boots, [2.5, 97.5])
    return float(np.median(r)), float(lo), float(hi)


# -------------------------------- driver -------------------------------- #

def _sweep_times(problem, l, calls, tmp):
    import jax
    eng = problem._kernel_engine(precompile=False)
    T = eng._tiers()[0]
    fn = eng._sweep(l, T, False)
    key = jax.random.key(7)
    for _ in range(3):
        fn(key, 0, T).block_until_ready()
    t = time.perf_counter()
    for _ in range(calls):
        fn(key, 0, T).block_until_ready()
    wall = (time.perf_counter() - t) / calls
    d = tempfile.mkdtemp(dir=tmp)
    with jax.profiler.trace(d):
        for _ in range(calls):
            fn(key, 0, T).block_until_ready()
    busy, names = device_busy(d)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:4]
    return T, wall, busy / calls * 1e-9, [(k, v / calls * 1e-3)
                                         for k, v in top]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grids", type=int, nargs="+", default=[1024, 256, 64])
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--accuracy-only", action="store_true")
    ap.add_argument("--save-graph", default=None,
                    help="write the pilot's model graph (npz) here")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "triton_ab"))
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import bluest_tpu.config  # noqa: F401  (x64 + compile cache)
    import jax
    import bench
    import chip_smoke

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("needs a GPU; JAX reports %r" % dev.platform)
    card = bench.nvidia_smi(*bench.CARD_QUERY)
    print("card: %s | jax %s %s" % (card, jax.__version__, dev.device_kind),
          flush=True)
    os.makedirs(args.out, exist_ok=True)
    cfg = chip_smoke.full_config()
    res = {"card": card}

    t = time.perf_counter()
    # --accuracy-only needs no pilot: any covariance will do
    src = ({"C": [1.0 + np.eye(len(cfg["grids"]))] * 3} if args.accuracy_only
           else {"covariance_estimation_samples": cfg["pilot"]})
    # the pilot runs on the default path, as in chip_smoke.py
    pt = chip_smoke.make_problem(cfg, **src)
    px = chip_smoke.make_problem(cfg, cls=plain_path_class(),
                                 C=pt.get_covariances())
    print("problems %.1f s" % (time.perf_counter() - t), flush=True)
    if args.save_graph:
        pt.save_graph_data(args.save_graph)

    acc = {}
    for l, n in enumerate(cfg["grids"]):
        ex = chip_smoke._model_errors(cfg, px, l, cfg["seed"] + 1)
        et = chip_smoke._model_errors(cfg, pt, l, cfg["seed"] + 1)
        acc[n] = {"xla": ex, "triton": et}
        print("acc grid %4d  xla med/max %.2e/%.2e  triton %.2e/%.2e"
              % (n, *ex, *et), flush=True)
        # the kernel is held to the card's plain-path bound of chip_smoke
        if et[0] > 2 * ex[0] + 1e-6 or et[1] > 4 * ex[1] + 1e-6:
            raise SystemExit("triton kernel outside the XLA error class at "
                             "grid %d" % n)
    res["accuracy"] = acc
    if args.accuracy_only:
        print(json.dumps(res))
        return 0

    peak = bench.device_peaks(dev.platform, dev.device_kind)["hbm_gb_s"]
    res["sweeps"] = {}
    for n in args.grids:
        l = cfg["grids"].index(n)
        for name, p in (("xla", px), ("triton", pt)):
            T, wall, busy, top = _sweep_times(p, l, args.calls, args.out)
            share = bench.bytes_per_sample(l) * T / busy / (peak * 1e9)
            res["sweeps"]["%s_%d" % (name, n)] = dict(
                B=T, wall_us=wall * 1e6, busy_us=busy * 1e6,
                hbm_share=share, top_us=top)
            print("n=%4d %-6s B=%d wall/call %.1f us  busy/call %.1f us  "
                  "HBM share %.3f  top %s"
                  % (n, name, T, wall * 1e6, busy * 1e6, share,
                     [(k, round(v, 1)) for k, v in top]), flush=True)

    t = time.perf_counter()
    K = cfg["K"]
    budget = bench.calibrate_budget(pt, k=K, target=cfg["target"])
    pt.setup_solver(K=K, budget=budget)
    px.MOSAP, px.MOSAP_output = pt.MOSAP, pt.MOSAP_output
    print("allocation %.1f s, budget %r, %d evaluations, certificates %s"
          % (time.perf_counter() - t, budget, bench.total_evaluations(px),
             [(c["form"], c["status"], c["relgap"], c["pres"], c["dres"])
              for c in px.MOSAP.certificates]), flush=True)
    walls = {"xla": [], "triton": []}
    est = {}
    for name, p in (("xla", px), ("triton", pt)):
        for _ in range(3):
            est[name] = np.asarray(p.solve(K=K, budget=budget)[0]).tolist()
    for r in range(args.rounds):
        order = (("xla", px), ("triton", pt))
        for name, p in (order if r % 2 == 0 else order[::-1]):
            t = time.perf_counter()
            p.solve(K=K, budget=budget)
            walls[name].append(time.perf_counter() - t)
    res["e2e"] = {k: {"median_s": float(np.median(v)), "all_s": v}
                  for k, v in walls.items()}
    # the two solves of a round ran back to back: pair them
    ratio, lo, hi = paired_ratio(walls["triton"], walls["xla"])
    res["e2e"]["triton_over_xla"] = {"median": ratio, "ci95": [lo, hi]}
    res["estimates"] = est
    res["budget"] = budget
    print("e2e solve (%d evaluations, %d ABBA rounds): xla median %.4f s, "
          "triton median %.4f s, paired ratio triton/xla %.3f (95%% "
          "bootstrap interval %.3f-%.3f)"
          % (bench.total_evaluations(px), args.rounds,
             res["e2e"]["xla"]["median_s"], res["e2e"]["triton"]["median_s"],
             ratio, lo, hi), flush=True)

    # device busy time of whole solves, against the solve's median wall
    for name, p in (("xla", px), ("triton", pt)):
        d = tempfile.mkdtemp(dir=args.out)
        with jax.profiler.trace(d):
            for _ in range(args.calls):
                p.solve(K=K, budget=budget)
        busy = device_busy(d)[0] / args.calls * 1e-9
        idle = 1.0 - busy / res["e2e"][name]["median_s"]
        res["e2e"][name].update(busy_s=busy, idle_share=idle)
        print("solve %-6s device busy %.4f s per solve, idle share %.3f of "
              "the median wall" % (name, busy, idle), flush=True)
    print(json.dumps(res, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
