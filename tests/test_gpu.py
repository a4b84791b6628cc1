"""Tests that need a GPU.  They carry the ``gpu`` marker, skip elsewhere
(the ``gpu`` fixture decides at run time), and run on the card inside
``python chip_smoke.py`` (phase e)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import bench
from bluest_tpu.config import allocation_device, allocation_device_scope
from bluest_tpu.models.diffusion import DiffusionProblem

pytestmark = pytest.mark.gpu


def _problem(dtype, cls=DiffusionProblem):
    grids = (64, 16, 4)
    C = [np.eye(3) + 0.5 for _ in range(3)]      # known: no pilot run
    return cls(grids=grids, n_kl=8, sigma=1.0, nu=0.6, multi_output=True,
               verbose=False, C=C, device_batch_size=256, dtype=dtype)


def test_f64_sweep_on_card_matches_reference(gpu):
    """The engine's sweep, compiled for the card, against the plain f64
    numpy/scipy reference."""
    p = _problem(None)
    eng = p._kernel_engine(precompile=False)
    key = jax.random.key(3)
    n = 200
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    xis = np.asarray(jax.vmap(p.sample_input_jax)(keys))
    for l, g in enumerate(p.grids):
        out = eng._sweep(l, eng._bucket(n)[0], False)(key, 0, n)
        assert {d.platform for d in out.devices()} == {"gpu"}
        ref = bench.reference_outputs(xis, g, 8, 1.0, 0.6)
        np.testing.assert_allclose(np.asarray(out)[:n], ref, rtol=1e-9)


def test_allocation_on_host_cpu_sampling_on_card(gpu):
    """Allocation arrays are committed to the host CPU device while the
    sampling sums stay on the card."""
    assert allocation_device().platform == "cpu"
    with allocation_device_scope():
        a = jnp.ones(3) @ jnp.ones(3)
    assert {d.platform for d in a.devices()} == {"cpu"}
    p = _problem(jnp.float32)
    sums = p._kernel_engine(precompile=False).sample_sums(
        [0, 1], jax.random.key(0), 300)
    assert {d.platform for d in sums.sumse.devices()} == {"gpu"}
    assert np.all(np.isfinite(np.asarray(sums.sumsc)))


def test_triton_kernel_compiled_on_card(gpu):
    """The f32 sweep on the card lowers to the Triton kernel (no
    interpreter), and its outputs match the plain XLA path within the f32
    error class and the f64 reference."""
    p32 = _problem(jnp.float32)
    class PlainPath(DiffusionProblem):       # the engine's vmapped path
        evaluate_model_jax_batched = None

    plain = _problem(jnp.float32, cls=PlainPath)
    key = jax.random.key(5)
    n = 256
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n))
    xis = np.asarray(jax.vmap(p32.sample_input_jax)(keys), np.float64)
    for l, g in enumerate(p32.grids):
        sweep = p32._kernel_engine(precompile=False)._sweep(l, n, False)
        assert "triton" in sweep.lower(key, 0, n).as_text().lower()
        got = np.asarray(sweep(key, 0, n), np.float64)
        ref = bench.reference_outputs(xis, g, 8, 1.0, 0.6)
        xla = np.asarray(plain._kernel_engine(precompile=False)._sweep(
            l, n, False)(key, 0, n), np.float64)
        err_k = np.median(np.abs(got - ref) / ref)
        err_x = np.median(np.abs(xla - ref) / ref)
        assert err_k <= 2 * err_x + 1e-6
