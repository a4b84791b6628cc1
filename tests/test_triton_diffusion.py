"""The fused diffusion kernel (bluest_tpu/ops/triton_diffusion.py), run
by JAX's Pallas interpreter on the CPU, against the library's plain model;
and DiffusionProblem's choice between it and the plain path."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from bluest_tpu.models.diffusion import (DiffusionProblem, solve_diffusion,
                                         solve_diffusion_outputs)
from bluest_tpu.ops.triton_diffusion import diffusion_outputs_triton


def _plain(xis, n, sigma, nu, n_modes):
    masked = xis * (jnp.arange(xis.shape[1]) < n_modes)
    return jax.vmap(lambda x: solve_diffusion_outputs(x, n, sigma, nu))(
        masked)


@pytest.mark.parametrize("n,n_modes,sigma,nu", [
    (32, 8, 1.0, 0.6), (16, 4, 1.0, 0.6), (8, 2, 0.5, 1.5), (4, 1, 1.0, 0.6),
    (2, 1, 1.0, 0.6)])
def test_kernel_matches_plain_model(n, n_modes, sigma, nu):
    """f64 through the interpreter: the kernel's Thomas sweep solves the
    system the plain path solves by cyclic reduction."""
    xis = jnp.asarray(np.random.default_rng(n).standard_normal((16, 8)))
    got = diffusion_outputs_triton(xis, n, sigma, nu, n_modes, block=8,
                                   interpret=True)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(_plain(xis, n, sigma, nu, n_modes)),
                               rtol=1e-10)


def test_kernel_pads_batch_modes_and_grid():
    """B=20 in blocks of 8, n_kl=6 and a 12-cell grid (the plain path's
    Thomas scan) are padded to the powers of two Triton needs."""
    xis = jnp.asarray(np.random.default_rng(7).standard_normal((20, 6)))
    got = diffusion_outputs_triton(xis, 12, 1.0, 0.6, 3, block=8,
                                   interpret=True)
    assert got.shape == (20, 3)
    np.testing.assert_allclose(np.asarray(got),
                               np.asarray(_plain(xis, 12, 1.0, 0.6, 3)),
                               rtol=1e-10)


def test_kernel_f32_within_f32_error():
    xis = np.random.default_rng(3).standard_normal((16, 8))
    got = diffusion_outputs_triton(jnp.asarray(xis, jnp.float32), 64, 1.0,
                                   0.6, 8, block=8, interpret=True)
    want = _plain(jnp.asarray(xis), 64, 1.0, 0.6, 8)
    assert got.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want),
                               rtol=2e-4)


def test_kernel_rejects_one_cell():
    with pytest.raises(ValueError, match="at least 2 cells"):
        diffusion_outputs_triton(jnp.ones((8, 4)), 1, 1.0, 0.6)


def _problem(**kw):
    return DiffusionProblem(grids=(16, 8, 4), n_kl=8, sigma=1.0, nu=0.6,
                            verbose=False, device_batch_size=16,
                            C=[1.0 + np.eye(3)] * 3, **kw)


@pytest.mark.parametrize("dtype", [jnp.float32, None])
@pytest.mark.parametrize("multi_output", [True, False])
def test_problem_batched_path_off_gpu_is_plain(dtype, multi_output):
    """Lowered for the CPU, the batched path is the plain model (the
    kernel is chosen only for a CUDA GPU, and only for f32)."""
    p = _problem(multi_output=multi_output, dtype=dtype)
    xis = jnp.asarray(np.random.default_rng(1).standard_normal((5, 8)),
                      dtype or jnp.float64)
    got = jax.jit(lambda x: p.evaluate_model_jax_batched(1, x))(xis)
    want = jax.jit(jax.vmap(lambda t: p.evaluate_model_jax(1, t)))(xis)
    assert got.shape == (5, 3 if multi_output else 1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_problem_sums_on_cpu_match_the_engine_default():
    """On the CPU the problem's batched path gives the sums of the
    engine's own vmapped path bit for bit."""
    class PlainPath(DiffusionProblem):
        evaluate_model_jax_batched = None

    kw = dict(grids=(16, 8, 4), n_kl=8, sigma=1.0, nu=0.6,
              multi_output=True, verbose=False, device_batch_size=16,
              C=[1.0 + np.eye(3)] * 3, dtype=jnp.float32)
    key = jax.random.key(4)
    s1 = DiffusionProblem(**kw)._kernel_engine(precompile=False).sample_sums(
        [0, 2], key, 40)
    s2 = PlainPath(**kw)._kernel_engine(precompile=False).sample_sums(
        [0, 2], key, 40)
    for name in ("sumse", "sumsc"):
        np.testing.assert_array_equal(np.asarray(getattr(s1, name)),
                                      np.asarray(getattr(s2, name)))


def test_problem_single_output_is_integral():
    """The single-output QoI is the first of the kernel's three."""
    xis = jnp.asarray(np.random.default_rng(2).standard_normal((8, 8)))
    q = diffusion_outputs_triton(xis, 16, 1.0, 0.6, 4, block=8,
                                 interpret=True)
    want = jax.vmap(lambda x: solve_diffusion(
        x * (jnp.arange(8) < 4), 16, 1.0, 0.6))(xis)
    np.testing.assert_allclose(np.asarray(q[:, 0]), np.asarray(want),
                               rtol=1e-10)
