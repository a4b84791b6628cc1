"""Global numerical configuration for bluest_tpu.

The allocation optimization (SDP / Newton solvers) and the estimator assembly
require float64 to reach the ~1e-8 agreement targets of the reference
(croci/bluest).  The allocation problems are tiny (L <= a few hundred
groups, M <= tens of models), and the Monte Carlo hot loop can run the
*model* in f32 while accumulating sums in f64.

Importing this module enables jax x64 once, before any arrays are created,
and places the persistent compilation cache (see below).
"""

from __future__ import annotations

import os
import platform

# Optional portable-ISA cap for XLA:CPU (BLUEST_TPU_MAX_ISA=AVX2),
# set BEFORE any backend initialization.  XLA:CPU AOT-compiles against
# the FULL feature set of the compiling machine -- including tuning
# pseudo-features like prefer-no-scatter -- and the persistent-cache
# loader refuses (or worse, SIGSEGVs on) executables whose features the
# running machine lacks; on mixed-CPU fleets every move to another CPU
# makes a cold start recompile (measured 1s -> 8s bench alloc).
# Capping the ISA at AVX2 strips amx/avx512/prefer-no-* from the target
# (verified against this build's cache entries) so executables load
# anywhere, and an ABBA A/B on the Hodgkin-Huxley K=5 golden (L ~ 400)
# measured the cap as a wash on the fused IPM (B/A 0.988).  It is OFF
# by default because the SAME cap is pathological on the XL fused
# program: the L = 3301 stress instance runs in ~34 s uncapped and did
# not finish in 25 minutes capped (killed; LLVM compile or kernel blowup
# under AVX2 on the giant module).  Opt in only for moderate-L
# workloads on heterogeneous fleets.  Respected only if the user has
# not already set an xla_cpu_max_isa in XLA_FLAGS; changing it changes
# every cache key once (one-time cold suite).
if (platform.machine() == "x86_64"
        and "xla_cpu_max_isa" not in os.environ.get("XLA_FLAGS", "")):
    _isa = os.environ.get("BLUEST_TPU_MAX_ISA", "")
    if _isa:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_cpu_max_isa=" + _isa).strip()

import jax

jax.config.update("jax_enable_x64", True)

# Persistent compilation cache.  When JAX_COMPILATION_CACHE_DIR is set,
# JAX reads it itself and this module sets no other directory.  Otherwise
# the cache lives at one fixed path inside the checkout (a path that moves
# never hits: it is part of the cache key), in a subdirectory named after
# the host CPU's features -- JAX's cache key does not include them, and an
# XLA:CPU executable compiled on one CPU can crash when loaded on another
# (a copied working tree carries its cache to a machine with a different
# CPU).  JAX_ENABLE_COMPILATION_CACHE=false turns the cache off.

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STATE_DIR = os.path.join(_CHECKOUT, ".bluest_cache")


def _host_cpu_fingerprint() -> str:
    import hashlib
    feats = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats += " " + " ".join(sorted(line.split(":", 1)[1]
                                                   .split()))
                    break
    except OSError:  # pragma: no cover - non-Linux fallback
        feats += " " + platform.processor()
    return hashlib.sha1(feats.encode()).hexdigest()[:12]


def default_cache_dir() -> str:
    """The in-checkout compile-cache path used when
    JAX_COMPILATION_CACHE_DIR is not set."""
    return os.path.join(STATE_DIR, "xla-cpu-" + _host_cpu_fingerprint())


if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", default_cache_dir())
# 0.1s, not the 1.0s default: the allocation path leans on many 0.2-0.5s
# programs (cleanup-matrix kernels, corner-search eigh chunks) that the
# default threshold silently recompiles in EVERY fresh process
jax.config.update("jax_persistent_cache_min_compile_time_secs",
                  float(os.environ.get("BLUEST_TPU_CACHE_MIN_COMPILE_S",
                                       "0.1")))

# Default dtypes used throughout the library.
import numpy as np

REAL = np.float64
INDEX = np.int32

def allocation_device():
    """Device the allocation optimization runs on.

    The MLBLUE allocation problems are tiny (a few hundred variables) and
    the IPM is f64 throughout, so by default it runs on the host CPU
    backend.  Override with BLUEST_TPU_ALLOC_DEVICE=default to keep it on
    the main device.  This default was chosen on the previous
    accelerator, which emulated f64; it is not yet measured on the H100,
    which runs f64 natively (ROADMAP A2).  The IPM perf knobs
    (BLUEST_TPU_GONDZIO / BLUEST_TPU_WOOD_PAD) cite host-backend ABBA
    data (solvers/sdp.py) because the host backend is where the IPM runs.
    """
    import jax
    if os.environ.get("BLUEST_TPU_ALLOC_DEVICE", "cpu") == "cpu":
        try:
            # local, not global: under jax.distributed the global device
            # list leads with process 0's CPU, which is NOT addressable
            # from the other processes -- pinning to it would crash every
            # non-zero process's allocation solve
            cpus = jax.local_devices(backend="cpu")
            if cpus:
                return cpus[0]
        except RuntimeError:
            pass
    return None


import contextlib


@contextlib.contextmanager
def allocation_device_scope():
    """Context form of on_allocation_device."""
    import jax
    dev = allocation_device()
    if dev is None:
        yield
    else:
        with jax.default_device(dev):
            yield


def on_allocation_device(fn):
    """Decorator pinning a function's JAX work to allocation_device()."""
    import functools

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        import jax
        dev = allocation_device()
        if dev is None:
            return fn(*args, **kwargs)
        with jax.default_device(dev):
            return fn(*args, **kwargs)

    return wrapper


# Threshold below which a correlation is treated as "uncorrelated"
# (reference: blue_models.py:344, blue_models.py:413).
UNCORRELATED_RHO_TOL = 1.0e-7

# Eigenvalue clip used when projecting covariances onto the SPD cone
# (reference: spg_default_params["spd_threshold"], blue_models.py:13).
SPD_THRESHOLD = 5.0e-14
