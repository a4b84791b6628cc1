"""CPU tests of tools/triton_diffusion_ab.py: the trace reduction and the
paired-ratio interval it reports."""

import importlib.util
import os

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "triton_diffusion_ab", os.path.join(ROOT, "tools",
                                        "triton_diffusion_ab.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)


def test_union_of_trace_intervals():
    assert tool.union_ns([(20, 25), (0, 10), (5, 15), (21, 22)]) == 20
    assert tool.union_ns([]) == 0


def test_paired_ratio_interval():
    a = np.linspace(1.0, 2.0, 40)
    med, lo, hi = tool.paired_ratio(0.9 * a, a)
    assert med == pytest.approx(0.9) and lo == pytest.approx(0.9)
    assert hi == pytest.approx(0.9)
    noisy = 0.95 * a * (1 + 0.1 * np.sin(np.arange(40)))
    med, lo, hi = tool.paired_ratio(noisy, a)
    assert lo <= med <= hi and lo < 0.95 < hi


def test_device_busy_reads_a_recorded_trace(tmp_path):
    """The reduction reads a real jax.profiler trace (of the host CPU
    here, whose plane holds no stream lines: busy 0)."""
    import jax
    import jax.numpy as jnp
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    f(jnp.ones((32, 32))).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        f(jnp.ones((32, 32))).block_until_ready()
    busy, names = tool.device_busy(str(tmp_path), plane_prefix="/host:CPU")
    assert busy == 0 and names == {}
    with pytest.raises(FileNotFoundError):
        tool.device_busy(str(tmp_path / "none"))
