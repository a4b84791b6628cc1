"""CPU tests of what the GPU smoke run (chip_smoke.py) and the bench rest
on: the plain reference, the phase functions at tiny widths, the refusal
to run without a GPU, the compile-cache placement, the multi-device dry
run and the peak table."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import bench
import chip_smoke
from bluest_tpu.models.diffusion import (DiffusionProblem,
                                         solve_diffusion_outputs)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = dict(grids=(16, 8, 4, 2), n_kl=8, sigma=1.0, nu=0.6, K=3,
            pilot=256, batch=64, target=5000, n_model=64, n_mc=2000, seed=0)


# ----------------------------- the reference ----------------------------- #

@pytest.mark.parametrize("n", bench.GRIDS)
def test_reference_matches_model_at_bench_grid(n):
    """bench.reference_outputs (numpy/scipy banded LU) against the
    library's solve_diffusion_outputs at each bench grid: f64 to 1e-9,
    f32 within its error class (set by the lognormal coefficient's
    conditioning; measured medians ~1.5e-3 at n=1024)."""
    rng = np.random.default_rng(n)
    xis = rng.standard_normal((64, bench.N_KL))
    keep = np.arange(bench.N_KL) < max(1, n // 4)
    ref = bench.reference_outputs(xis, n)
    assert ref.shape == (64, 3) and np.all(ref > 0)

    def run(dtype):
        f = jax.vmap(lambda t: solve_diffusion_outputs(t, n, bench.SIGMA,
                                                       bench.NU))
        got = np.asarray(f(jnp.asarray(xis * keep, dtype)), np.float64)
        return np.abs(got - ref) / np.abs(ref)

    assert np.max(run(jnp.float64)) <= 1e-9
    err32 = run(jnp.float32)
    assert np.median(err32) <= 2e-6 * n + 1e-6
    assert np.max(err32) <= 2e-4 * n + 1e-5


def test_numpy_model_eval_is_the_reference():
    """The baseline's per-sample model loop and the smoke reference are
    the same computation."""
    xi = np.random.default_rng(1).standard_normal(bench.N_KL)
    got = bench.numpy_model_eval((0, 5, 9), xi)
    for j, l in enumerate((0, 5, 9)):
        np.testing.assert_array_equal(
            got[:, j], bench.reference_outputs(xi[None], bench.GRIDS[l])[0])


def test_user_batched_hook_through_engine():
    """A user-supplied evaluate_model_jax_batched replaces the vmapped
    per-sample model inside the engine's sweeps."""
    class Doubled(DiffusionProblem):
        def evaluate_model_jax_batched(self, l, xis):
            return 2.0 * jax.vmap(lambda t: jnp.asarray(
                self.evaluate_model_jax(l, t)))(xis)

    kw = dict(grids=(32, 16, 8), n_kl=8, sigma=0.5, nu=1.5,
              multi_output=True, verbose=False, device_batch_size=32,
              C=[1.0 + np.eye(3)] * 3, dtype=jnp.float32)
    plain, doubled = DiffusionProblem(**kw), Doubled(**kw)
    key = jax.random.key(2)
    s1 = plain._kernel_engine(precompile=False).sample_sums([0, 1], key, 70)
    s2 = doubled._kernel_engine(precompile=False).sample_sums([0, 1], key,
                                                              70)
    np.testing.assert_array_equal(np.asarray(s2.sumse),
                                  2.0 * np.asarray(s1.sumse))
    np.testing.assert_array_equal(np.asarray(s2.sumsc),
                                  4.0 * np.asarray(s1.sumsc))


# ---------------------------- the smoke script --------------------------- #

def _run_smoke(cwd, script, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_smoke_fails_without_gpu():
    out = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs 'gpu'" in out.stderr


def test_smoke_fails_alone(tmp_path):
    """Copied into a directory without the repository, the script fails
    before touching any device."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_smoke(str(tmp_path), "chip_smoke.py",
                     {"PYTHONPATH": "", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_smoke_phases_device_and_model_tiny():
    dev = chip_smoke.phase_device("cpu")
    assert dev == {"platform": "cpu", "kind": "cpu",
                   "count": len(jax.devices())}
    with pytest.raises(chip_smoke.SmokeFailure, match="needs 'gpu'"):
        chip_smoke.phase_device("gpu")
    p32 = chip_smoke.make_problem(TINY, C=[1.0 + np.eye(4)] * 3)
    p64 = chip_smoke.make_problem(TINY, f64=True, C=[1.0 + np.eye(4)] * 3)
    rows = chip_smoke.phase_model(TINY, p32, p64, "cpu")
    assert [r[0] for r in rows] == list(TINY["grids"])
    for n, c32, d32, h32, c64, d64 in rows:
        assert d32 == c32 and h32 == c32       # same backend, same inputs
        assert d64[1] <= 1e-9


def test_smoke_phases_main_path_tiny():
    counter = chip_smoke.CompileCounter()
    p = chip_smoke.make_problem(TINY,
                                covariance_estimation_samples=TINY["pilot"])
    mus, errs = chip_smoke.phase_main(TINY, p, counter, 0.0, "cpu")
    assert mus.shape == (3,) and np.all(errs > 0)
    chip_smoke.phase_one_process("cpu")


def test_smoke_phase_mesh_on_virtual_devices():
    """The --four-cards comparison, rehearsed on the suite's virtual CPU
    devices (mesh='auto' spans all of them)."""
    assert len(jax.devices()) > 1
    chip_smoke.phase_mesh(TINY)


def test_smoke_phase_mesh_fails_on_other_samples(monkeypatch):
    """A mesh that draws other samples than one device fails the
    per-sample check: its limit is fixed, not taken from the run."""
    draw = DiffusionProblem.sample_input_jax

    def shifted(self, key):
        if getattr(self, "mesh", None) is not None:
            key = jax.random.fold_in(key, 1)
        return draw(self, key)

    monkeypatch.setattr(DiffusionProblem, "sample_input_jax", shifted)
    with pytest.raises(chip_smoke.SmokeFailure, match="per-sample outputs"):
        chip_smoke.phase_mesh(TINY)


def test_smoke_phase_tests_collects_only_gpu_modules():
    assert [os.path.basename(f) for f in chip_smoke.gpu_test_files()] == [
        "test_gpu.py"]


# --------------------------- multi-device dry run ------------------------ #

def test_dryrun_multichip_four_virtual_devices():
    import __graft_entry__
    __graft_entry__.dryrun_multichip(4)


def test_dryrun_multichip_raises_without_devices():
    import __graft_entry__
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        __graft_entry__.dryrun_multichip(64)


# ------------------------------ compile cache ---------------------------- #

_PROBE = ("import bluest_tpu.config, jax, jax.numpy as jnp; "
          "jax.jit(lambda x: jnp.sin(x) @ x)(jnp.ones((8, 8))); "
          "print(jax.config.jax_compilation_cache_dir)")


def _probe_cache(env_extra):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", BLUEST_TPU_CACHE_MIN_COMPILE_S="0",
               **env_extra)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_compile_cache_honours_env_dir(tmp_path):
    where = str(tmp_path / "xla")
    assert _probe_cache({"JAX_COMPILATION_CACHE_DIR": where}) == where
    assert os.listdir(where)                   # the program was cached


def test_compile_cache_default_in_checkout():
    from bluest_tpu import config
    where = _probe_cache({})
    assert where == config.default_cache_dir()
    assert where.startswith(os.path.join(ROOT, ".bluest_cache") + os.sep)
    assert os.listdir(where)


# ------------------------------- peak table ------------------------------ #

@pytest.mark.parametrize("platform,kind,want", [
    ("gpu", "NVIDIA H100 80GB HBM3", 67e12),
    ("cpu", "cpu", None),
    ("gpu", "Some Other GPU", KeyError),
])
def test_device_peaks(platform, kind, want):
    if want is KeyError:
        with pytest.raises(KeyError, match="no published peaks"):
            bench.device_peaks(platform, kind)
    elif want is None:
        assert bench.device_peaks(platform, kind) is None
    else:
        peaks = bench.device_peaks(platform, kind)
        assert peaks["flops"] == want and peaks["hbm_gb_s"] == 3350.0
