#!/usr/bin/env python
"""Smoke run of the bench deployment on an NVIDIA GPU.

Drives the path users run -- ``DiffusionProblem`` (pilot covariance) ->
``setup_solver`` (allocation) -> ``solve`` (sampling) -- once, at the
width ``bench.py`` defines: 10 fidelities on grids 1024..2, 32 KL modes,
3 outputs, f32 models, device batch 8192, a 4096-sample pilot, K=4
(L = 385 groups) and a budget for ~1e6 coupled samples.  Every phase is
checked against the plain numpy/scipy reference (``bench.reference_outputs``).

    python chip_smoke.py               # one card: phases (a)-(e)
    python chip_smoke.py --four-cards  # four cards: the sample-mesh solve
                                       # against one card, and the 2D-mesh
                                       # dry run; nothing else

Phases on one card:
  (a) device: JAX must report a GPU (there is no switch to the CPU);
      prints its kind and count, the card's name and power limit from
      nvidia-smi, and whether the native host library loaded.
  (b) model: each fidelity through the engine's own sweep for 1024
      seeded samples, against the f64 reference.  On the card the f32
      sweeps must call the fused Triton kernel
      (bluest_tpu/ops/triton_diffusion.py).  The f32 path must stay
      within 2x (median) and 4x (max) the error that the same sweep shows
      on the CPU backend (measured in this process, on the same inputs),
      at default and at "highest" matmul precision; the f64 path within
      max(1e-9, 10x the CPU f64 error).
  (c) main path: pilot, allocation, a cold and a warm solve.  Every
      certificate passes the library's optimality gate (is_tight), no
      NLP fallback, estimates finite and within
      4 sigma of a plain f64 Monte Carlo mean of model 0; the allocation
      arrays live on the host CPU device and the sweep outputs on the card.
  (d) one process per card: nvidia-smi lists one process, and no child
      of this process (the IPM worker) holds the card's device file.
  (e) the tests marked ``gpu``, run by pytest inside this process (only
      the modules that hold them are collected).

With --four-cards: the bench solve on a sample mesh over every card
(mesh="auto") against one card with the same allocation and keys.  Per
sample, the f32 outputs may differ by at most MESH_SAMPLE_RTOL (a fixed
f32 rounding limit); the f64 group sums and the estimates must agree to
MESH_SUM_RTOL.  Then __graft_entry__.dryrun_multichip(4).

Each phase prints its own lines.  The last line of stdout is one JSON
object, {"ok": true, "device": {"platform", "kind", "count"}}, printed
only when every phase passed; a failed phase exits 1 without it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# f32 model error allowed on the card, as multiples of the same sweep's
# (median, max) relative error on the CPU backend, plus a floor of a few
# f32 ulps for grids where both are at rounding level.  The max is one
# sample in ~3000, amplified by the coefficient's conditioning from the
# last bits of exp and division, which differ between the backends; on
# the H100 at HIGHEST precision it reached 2.03x the CPU max at grid 64
F32_FACTOR = (2.0, 4.0)
F32_FLOOR = 1e-6
# f64 model error allowed on the card: max(F64_RTOL, F64_FACTOR x CPU)
F64_RTOL = 1e-9
F64_FACTOR = 10.0
# --four-cards: the sample mesh against one device.  The f64 group sums
# and the estimates must agree to the rtol the CPU sharding tests hold
# (tests/test_sharding.py).  Per sample, both run the same per-shard f32
# program on the same inputs; only XLA's fusion choices for the sharded
# and the plain program may reorder its rounding.  The limit is 64 f32
# ulps: a few ulps per reordered operation, amplified by the lognormal
# coefficient's conditioning.  A mesh that drew other samples, or put a
# shard's outputs in another's rows, moves them by their spread, O(0.1).
MESH_SUM_RTOL = 1e-12
MESH_SAMPLE_RTOL = 64 * 2.0 ** -23


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print("[%s] %s" % (phase, msg), flush=True)


def full_config():
    """The bench deployment (bench.py), at full width."""
    import bench
    return dict(grids=bench.GRIDS, n_kl=bench.N_KL, sigma=bench.SIGMA,
                nu=bench.NU, K=bench.K, pilot=bench.PILOT,
                batch=bench.BATCH, target=bench.TARGET_SAMPLES,
                n_model=1024, n_mc=20_000, seed=0)


def make_problem(cfg, f64=False, cls=None, **params):
    import jax.numpy as jnp
    from bluest_tpu.models.diffusion import DiffusionProblem
    return (cls or DiffusionProblem)(
        grids=cfg["grids"], n_kl=cfg["n_kl"], sigma=cfg["sigma"],
        nu=cfg["nu"], multi_output=True, verbose=False,
        device_batch_size=cfg["batch"],
        dtype=None if f64 else jnp.float32, **params)


class CompileCounter:
    """Counts XLA backend compiles and persistent-cache hits."""

    def __init__(self):
        import jax.monitoring
        self.compiles = 0
        self.cache_hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._event)

    def _dur(self, event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compiles += 1

    def _event(self, event, **kw):
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1

    def snapshot(self):
        return self.compiles, self.cache_hits


# ------------------------------ phase (a) ------------------------------ #

def phase_device(platform="gpu"):
    import jax
    import bench
    from bluest_tpu import _native
    devs = jax.devices()
    d = devs[0]
    say("a", "jax %s: platform=%s device_kind=%s count=%d"
        % (jax.__version__, d.platform, d.device_kind, len(devs)))
    check(d.platform == platform, "JAX reports platform %r; this run needs "
          "%r" % (d.platform, platform))
    card = bench.nvidia_smi(*bench.CARD_QUERY)
    if platform == "gpu":
        check(card, "nvidia-smi did not report the card's name and power "
              "limit")
    say("a", "card (nvidia-smi name, power.limit): %s"
        % (" | ".join(card) if card else "not available"))
    say("a", "native host library loaded: %s" % _native.available())
    return {"platform": d.platform, "kind": d.device_kind, "count": len(devs)}


# ------------------------------ phase (b) ------------------------------ #

def _sweep_and_inputs(problem, l, n, seed):
    """Outputs of the engine's sweep for model ``l`` on samples 0..n-1 of
    key ``seed``, and the inputs it drew, on JAX's default device."""
    import jax
    import jax.numpy as jnp
    eng = problem._kernel_engine(precompile=False)
    key = jax.random.key(seed)
    n_pad, _ = eng._bucket(n)
    out = np.asarray(eng._sweep(l, n_pad, False)(key, 0, n))[:n]
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    xis = np.asarray(jax.vmap(problem.sample_input_jax)(keys), np.float64)
    return np.asarray(out, np.float64), xis


def _model_errors(cfg, problem, l, seed):
    """(median, max) relative error of the sweep against the reference."""
    import bench
    out, xis = _sweep_and_inputs(problem, l, cfg["n_model"], seed)
    ref = bench.reference_outputs(xis, cfg["grids"][l], cfg["n_kl"],
                                  cfg["sigma"], cfg["nu"])
    err = np.abs(out - ref) / np.maximum(np.abs(ref), 1e-300)
    return float(np.median(err)), float(np.max(err))


def phase_model(cfg, problem32, problem64, platform="gpu"):
    """Model outputs on the card against the f64 reference, with the same
    sweep on the CPU backend as the error class."""
    import jax
    cpu = jax.devices("cpu")[0]
    seed = cfg["seed"] + 1
    say("b", "%d samples per grid through KernelEngineV2._sweep; relative "
        "error (median, max) against bench.reference_outputs (f64 numpy/"
        "scipy)" % cfg["n_model"])
    say("b", "f32 tolerance: (median, max) within (%.0fx, %.0fx) the CPU "
        "backend's + %.0e; f64: max within max(%.0e, %.0fx CPU)"
        % (*F32_FACTOR, F32_FLOOR, F64_RTOL, F64_FACTOR))
    fails = []
    rows = []
    if platform == "gpu":
        # f32 models run the fused Triton kernel on the card, compiled
        # (the lowered sweep holds the kernel's call, not the interpreter)
        eng = problem32._kernel_engine(precompile=False)
        T = eng._tiers()[0]
        fused = []
        for l in range(len(cfg["grids"])):
            text = eng._sweep(l, T, False).lower(jax.random.key(0), 0,
                                                 1).as_text()
            fused.append("triton" in text)
        say("b", "f32 sweeps lowered with the Triton kernel: %s" % fused)
        check(all(fused), "an f32 sweep on the card does not call the "
              "Triton kernel")
    for l, n in enumerate(cfg["grids"]):
        with jax.default_device(cpu):
            c32 = _model_errors(cfg, problem32, l, seed)
            c64 = _model_errors(cfg, problem64, l, seed)
        d32 = _model_errors(cfg, problem32, l, seed)
        with jax.default_matmul_precision("highest"):
            h32 = _model_errors(cfg, problem32, l, seed)
        d64 = _model_errors(cfg, problem64, l, seed)
        rows.append((n, c32, d32, h32, c64, d64))
        say("b", "grid %4d  f32 cpu %.2e/%.2e  %s default %.2e/%.2e  "
            "highest %.2e/%.2e | f64 max cpu %.2e %s %.2e"
            % (n, *c32, platform, *d32, *h32, c64[1], platform, d64[1]))
        for name, got in (("f32 default precision", d32),
                          ("f32 highest precision", h32)):
            lim = (F32_FACTOR[0] * c32[0] + F32_FLOOR,
                   F32_FACTOR[1] * c32[1] + F32_FLOOR)
            if got[0] > lim[0] or got[1] > lim[1]:
                fails.append("grid %d %s: median/max %.2e/%.2e over "
                             "%.2e/%.2e" % (n, name, *got, *lim))
        lim64 = max(F64_RTOL, F64_FACTOR * c64[1])
        if d64[1] > lim64:
            fails.append("grid %d f64: max %.2e over %.2e"
                         % (n, d64[1], lim64))
    check(not fails, "model outside its tolerance: " + "; ".join(fails))
    say("b", "PASS: %d grids, f32 (default and highest precision) and f64"
        % len(rows))
    return rows


# ------------------------------ phase (c) ------------------------------ #

def phase_main(cfg, problem, counter, pilot_s, platform="gpu"):
    """Allocation + solves on the pilot-built problem, checked against a
    plain Monte Carlo mean of model 0."""
    import jax
    import jax.numpy as jnp
    import bench
    from bluest_tpu.allocation.certificate import is_tight
    from bluest_tpu.config import allocation_device_scope
    from bluest_tpu.core import psi as psimod
    K, M = cfg["K"], len(cfg["grids"])
    say("c", "pilot (DiffusionProblem, %d samples): %.3f s"
        % (cfg["pilot"], pilot_s))

    t = time.perf_counter()
    budget = bench.calibrate_budget(problem, k=K, target=cfg["target"])
    problem.setup_solver(K=K, budget=budget)
    alloc_s = time.perf_counter() - t
    out = problem.MOSAP_output
    L = len(out["flattened_groups"])
    L_want = sum(math.comb(M, k) for k in range(1, min(K, M) + 1))
    n_samples = bench.total_samples(problem)
    say("c", "allocation (calibration + setup_solver K=%d): %.3f s, L=%d "
        "groups, budget %.6g, %d coupled samples, %d model evaluations"
        % (K, alloc_s, L, budget, n_samples, bench.total_evaluations(problem)))
    check(L == L_want, "L=%d groups, expected %d" % (L, L_want))
    # the IPM labels a solve "inaccurate" when its dual residual sits a
    # decade or so above the nominal 1e-8; is_tight is the library's own
    # gate for a certified optimum (relgap <= 1e-5, pres <= 1e-7,
    # dres <= 1e-6), so every certificate must pass it
    certs = problem.MOSAP.certificates
    for c in certs:
        say("c", "certificate %s: status %s, relgap %.2e, pres %.2e, "
            "dres %.2e, %d iterations" % (c["form"], c["status"],
                                          c["relgap"], c["pres"], c["dres"],
                                          c["iterations"]))
    say("c", "NLP fallbacks: %d" % problem.MOSAP.n_nlp_fallbacks)
    check(certs and all(is_tight(c) for c in certs),
          "a certificate is not tight")
    check(problem.MOSAP.n_nlp_fallbacks == 0, "the SDP fell back to the NLP")

    c0 = counter.snapshot()
    t = time.perf_counter()
    mus, errs, _ = problem.solve(K=K, budget=budget)
    cold_s = time.perf_counter() - t
    c1 = counter.snapshot()
    t = time.perf_counter()
    mus_w, errs_w, _ = problem.solve(K=K, budget=budget)
    warm_s = time.perf_counter() - t
    c2 = counter.snapshot()
    say("c", "solve: cold %.3f s (%d compiles, %d cache hits), warm %.3f s "
        "(%d compiles, %d cache hits)"
        % (cold_s, c1[0] - c0[0], c1[1] - c0[1], warm_s, c2[0] - c1[0],
           c2[1] - c1[1]))
    mus = np.asarray(mus, np.float64).ravel()
    errs = np.asarray(errs, np.float64).ravel()
    check(np.all(np.isfinite(mus)) and np.all(np.isfinite(errs))
          and np.all(np.isfinite(np.asarray(mus_w, np.float64))),
          "non-finite estimates %s +- %s" % (mus, errs))

    rng = np.random.default_rng(cfg["seed"])
    xis = rng.standard_normal((cfg["n_mc"], cfg["n_kl"]))
    ref = bench.reference_outputs(xis, cfg["grids"][0], cfg["n_kl"],
                                  cfg["sigma"], cfg["nu"])
    mc_mean, mc_std = ref.mean(axis=0), ref.std(axis=0, ddof=1)
    bound = 4.0 * np.sqrt(errs ** 2 + mc_std ** 2 / cfg["n_mc"])
    for q in range(len(mus)):
        say("c", "output %d: MLBLUE %.8g +- %.3g | plain MC (f64, N=%d) "
            "%.8g +- %.3g | |diff| %.3g <= %.3g"
            % (q, mus[q], errs[q], cfg["n_mc"], mc_mean[q],
               mc_std[q] / math.sqrt(cfg["n_mc"]), abs(mus[q] - mc_mean[q]),
               bound[q]))
    check(np.all(np.abs(mus - mc_mean) <= bound),
          "estimate outside 4 sigma of the Monte Carlo reference")

    # where the programs ran: default_device moves only uncommitted arrays
    sap = problem.MOSAP.SAPS[0]
    m0 = np.asarray(out["samples"], np.float64)[problem.MOSAP.mappings[0]]
    with allocation_device_scope():
        cleanup = psimod.cleanup_matrix(sap.data, jnp.asarray(m0), 0.0)
    eng = problem._kernel_engine()
    sweep = eng._sweep(0, eng._tiers()[0], False)(jax.random.key(0), 0, 1)
    places = {"allocation psi (built in setup_solver)": sap.data.psi,
              "allocation cleanup matrix": cleanup,
              "sweep output": sweep}
    for name, arr in places.items():
        say("c", "%s on %s" % (name, sorted(str(d) for d in arr.devices())))
    for name in ("allocation psi (built in setup_solver)",
                 "allocation cleanup matrix"):
        check({d.platform for d in places[name].devices()} == {"cpu"},
              "%s is not on the host CPU device" % name)
    check({d.platform for d in sweep.devices()} == {platform},
          "sweep output is not on the %s" % platform)
    stats = jax.devices()[0].memory_stats() or {}
    say("c", "peak_bytes_in_use: %s" % stats.get("peak_bytes_in_use",
                                                 "not reported"))
    say("c", "PASS")
    return mus, errs


# ------------------------------ phase (d) ------------------------------ #

def _children(pid):
    """PIDs of every descendant of ``pid`` (from /proc)."""
    parent = {}
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open("/proc/%s/stat" % entry) as f:
                    stat = f.read()
            except OSError:
                continue
            parent[int(entry)] = int(stat.rsplit(")", 1)[1].split()[1])
    out, frontier = [], [pid]
    while frontier:
        p = frontier.pop()
        kids = [c for c, pp in parent.items() if pp == p]
        out += kids
        frontier += kids
    return out


def _gpu_files(pid):
    """GPU device files (/dev/nvidia*) that process ``pid`` holds open."""
    held = set()
    try:
        for fd in os.listdir("/proc/%d/fd" % pid):
            try:
                target = os.readlink("/proc/%d/fd/%s" % (pid, fd))
            except OSError:
                continue
            if target.startswith("/dev/nvidia"):
                held.add(target)
    except OSError:
        pass
    return sorted(held)


def _card_files(files):
    """The per-card device files (/dev/nvidiaN) among ``files``; the
    control and unified-memory nodes belong to no card."""
    return [f for f in files if f[len("/dev/nvidia"):].isdigit()]


def phase_one_process(platform="gpu"):
    me = os.getpid()
    kids = _children(me)
    from bluest_tpu.solvers import ipm_worker
    client = ipm_worker._CLIENT
    worker = (client._proc.pid if client is not None and client._proc
              is not None and client._proc.poll() is None else None)
    say("d", "this process %d; children %s; IPM worker %s"
        % (me, kids, worker))
    if platform == "gpu":
        import bench
        apps = bench.nvidia_smi("--query-compute-apps=pid",
                                "--format=csv,noheader")
        say("d", "nvidia-smi compute apps: %s" % (apps or "none listed"))
        check(apps is not None, "nvidia-smi --query-compute-apps failed")
        check(len(apps) <= 1, "more than one process on the card: %s" % apps)
        if apps:
            say("d", "listed PID %s %s" % (apps[0], "is this process"
                                           if int(apps[0]) == me else
                                           "(another PID namespace)"))
        mine = _gpu_files(me)
        say("d", "this process holds %s" % mine)
        check(_card_files(mine), "this process holds no card device file")
    for pid in kids:
        held = _gpu_files(pid)
        say("d", "child %d holds %s" % (pid, held or "no GPU device file"))
        check(not _card_files(held), "child %d opened the card: %s"
              % (pid, held))
    say("d", "PASS: no child process opened the card")


# ------------------------------ phase (e) ------------------------------ #

def gpu_test_files():
    """The test modules that carry the ``gpu`` marker.  Only these are
    collected, so modules whose oracles need packages this machine may
    lack are not imported."""
    tests = os.path.join(HERE, "tests")
    found = []
    for name in sorted(os.listdir(tests)):
        if name.startswith("test_") and name.endswith(".py"):
            with open(os.path.join(tests, name)) as f:
                if "mark.gpu" in f.read():
                    found.append(os.path.join(tests, name))
    return found


def phase_tests():
    import pytest
    files = gpu_test_files()
    check(files, "no test module carries the gpu marker")
    say("e", "modules with gpu tests: %s"
        % [os.path.relpath(f, HERE) for f in files])
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", *files])
    check(rc == 0, "pytest -m gpu exited %s" % int(rc))
    say("e", "PASS: tests marked gpu")


# ----------------------------- four cards ------------------------------ #

def phase_mesh(cfg):
    """The same solve on a sample mesh over every device (mesh="auto") and
    on one device, with the same allocation and keys."""
    import jax
    import bench
    K = cfg["K"]
    t = time.perf_counter()
    pa = make_problem(cfg, covariance_estimation_samples=cfg["pilot"],
                      mesh="auto")
    check(pa.mesh is not None, "mesh='auto' built no mesh")
    S = pa.mesh.devices.size
    budget = bench.calibrate_budget(pa, k=K, target=cfg["target"])
    pa.setup_solver(K=K, budget=budget)
    with tempfile.TemporaryDirectory() as td:
        graph = os.path.join(td, "graph.npz")
        pa.save_graph_data(graph)
        pb = make_problem(cfg, datafile=graph)
    # one allocation for both: the comparison is of the sampling alone
    pb.MOSAP, pb.MOSAP_output = pa.MOSAP, pa.MOSAP_output
    say("mesh", "%d-device sample mesh vs one device; pilot + allocation "
        "%.3f s" % (S, time.perf_counter() - t))
    out = pa.MOSAP_output
    ea, eb = pa._kernel_engine(), pb._kernel_engine()

    # per-sample outputs: the mesh's sweep over one chunk per shard, and
    # the one-device sweep of the same tier run at each shard's offset, so
    # both run the same per-shard program on the same sample indices
    key = jax.random.key(cfg["seed"] + 2)
    T = cfg["batch"]
    n = T * S
    worst = 0.0
    for l in range(len(cfg["grids"])):
        oa = np.asarray(ea._sweep(l, T, False)(key, 0, n), np.float64)
        ob = np.concatenate([np.asarray(eb._sweep(l, T, False)(key, s * T, n),
                                        np.float64) for s in range(S)])
        check(oa.shape == ob.shape, "mesh sweep shape %s, one device %s"
              % (oa.shape, ob.shape))
        worst = max(worst, float(np.max(np.abs(oa - ob) / np.abs(ob))))
    say("mesh", "per-sample f32 outputs over %d samples x %d models: %s "
        "(largest relative difference %.3g, limit %.3g)"
        % (n, len(cfg["grids"]), "bit-equal" if worst == 0.0 else "differ",
           worst, MESH_SAMPLE_RTOL))
    check(worst <= MESH_SAMPLE_RTOL, "per-sample outputs of the mesh and "
          "one device differ by %.3g, over the f32 rounding limit %.3g"
          % (worst, MESH_SAMPLE_RTOL))
    rtol = MESH_SUM_RTOL

    base = jax.random.key(cfg["seed"] + 3)
    worst_sum = 0.0
    for i, (g, N) in enumerate(zip(out["flattened_groups"], out["samples"])):
        if int(N) <= 0:
            continue
        k = jax.random.fold_in(base, i)
        sa, sb = ea.sample_sums(g, k, int(N)), eb.sample_sums(g, k, int(N))
        for name in ("sumse", "sumsc", "sumsd2"):
            a = np.asarray(getattr(sa, name))
            b = np.asarray(getattr(sb, name))
            worst_sum = max(worst_sum, float(np.max(
                np.abs(a - b) / np.maximum(np.abs(b), 1e-300))))
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg="%s of %s"
                                       % (name, list(g)))
    say("mesh", "sums of the %d sampled groups: largest relative "
        "difference %.3g (rtol %.1e)"
        % (int(np.sum(out["samples"] > 0)), worst_sum, rtol))

    pa._call_counter = pb._call_counter = 1 << 20     # same key stream
    ma, _, _ = pa.solve(K=K, budget=budget)
    mb, _, _ = pb.solve(K=K, budget=budget)
    ma, mb = np.asarray(ma, np.float64), np.asarray(mb, np.float64)
    diff = float(np.max(np.abs(ma - mb) / np.abs(mb)))
    say("mesh", "solve estimates %s (mesh) vs %s (one device): largest "
        "relative difference %.3g" % (ma, mb, diff))
    check(diff <= rtol, "estimates differ by %.3g (rtol %.1e)"
          % (diff, rtol))
    say("mesh", "PASS")


def phase_dryrun(n):
    import __graft_entry__
    __graft_entry__.dryrun_multichip(n)
    say("dryrun", "PASS: dryrun_multichip(%d), 2D (samples, model) mesh "
        "against its single-device reference" % n)


# ------------------------------- drivers ------------------------------- #

def run_one_card(cfg, platform="gpu"):
    dev = phase_device(platform)
    counter = CompileCounter()
    t = time.perf_counter()
    problem = make_problem(cfg, covariance_estimation_samples=cfg["pilot"])
    pilot_s = time.perf_counter() - t
    twin64 = make_problem(cfg, f64=True, C=problem.get_covariances())
    phase_model(cfg, problem, twin64, platform)
    phase_main(cfg, problem, counter, pilot_s, platform)
    phase_one_process(platform)
    phase_tests()
    return dev


def run_four_cards(cfg, n=4, platform="gpu"):
    dev = phase_device(platform)
    check(dev["count"] == n, "%d devices; --four-cards needs %d"
          % (dev["count"], n))
    phase_mesh(cfg)
    phase_dryrun(n)
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh checks")
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    try:
        import bench  # noqa: F401  (the deployment and its reference)
        import bluest_tpu.config  # noqa: F401  (x64 + compile cache)
    except ImportError as exc:
        print("chip_smoke: the repository is not beside this script (%s)"
              % exc, file=sys.stderr)
        return 2
    cfg = full_config()
    try:
        dev = run_four_cards(cfg) if args.four_cards else run_one_card(cfg)
    except Exception as exc:  # noqa: BLE001 - any failure fails the run
        import traceback
        traceback.print_exc()
        print("chip_smoke: FAILED: %s: %s" % (type(exc).__name__, exc),
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
