"""Multi-fidelity, multi-output Hodgkin-Huxley neuron family.

Mirrors the reference's 12-model, 5-output paper example
(examples/paper_examples/hodgkin-huxley/blue_hodgkin-huxley.py; cost/QoI
structure per plot_histograms.py:42-50): the model set mixes integrator
fidelity (time step), integrator order (RK4 vs Euler) and model form
(full HH vs FitzHugh-Nagumo reduction); randomness enters through the
applied current and channel conductances.

Outputs (5, as in the reference): mean membrane potential, final V,
max V, a smooth spike-count proxy, and mean potassium activation.

Time stepping is a ``lax.scan``; under vmap the state update becomes a
(batch, 4)-wide elementwise computation per step.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..problem import BLUEProblem

# (kind, dt): kind 0 = HH RK4, 1 = HH Euler, 2 = FitzHugh-Nagumo RK4
DEFAULT_MODELS = (
    (0, 0.01), (0, 0.02), (0, 0.04), (0, 0.08),
    (1, 0.01), (1, 0.02), (1, 0.04), (1, 0.08),
    (2, 0.01), (2, 0.02), (2, 0.04), (2, 0.08),
)
T_END = 10.0
N_OUTPUTS = 5


def _hh_rhs(state, params):
    V, m, h, n = state
    I_app, gNa, gK = params
    gL, ENa, EK, EL, Cm = 0.3, 50.0, -77.0, -54.387, 1.0

    a_m = 0.1 * (V + 40.0) / (1.0 - jnp.exp(-(V + 40.0) / 10.0) + 1e-12)
    b_m = 4.0 * jnp.exp(-(V + 65.0) / 18.0)
    a_h = 0.07 * jnp.exp(-(V + 65.0) / 20.0)
    b_h = 1.0 / (1.0 + jnp.exp(-(V + 35.0) / 10.0))
    a_n = 0.01 * (V + 55.0) / (1.0 - jnp.exp(-(V + 55.0) / 10.0) + 1e-12)
    b_n = 0.125 * jnp.exp(-(V + 65.0) / 80.0)

    INa = gNa * m ** 3 * h * (V - ENa)
    IK = gK * n ** 4 * (V - EK)
    IL = gL * (V - EL)
    dV = (I_app - INa - IK - IL) / Cm
    dm = a_m * (1 - m) - b_m * m
    dh = a_h * (1 - h) - b_h * h
    dn = a_n * (1 - n) - b_n * n
    return jnp.stack([dV, dm, dh, dn])


def _fhn_rhs(state, params):
    v, w = state[0], state[1]
    I_app = params[0]
    a, b, tau = 0.7, 0.8, 12.5
    dv = v - v ** 3 / 3 - w + I_app / 10.0
    dw = (v + a - b * w) / tau
    return jnp.stack([dv, dw, jnp.zeros(()), jnp.zeros(())])


def _integrate(kind: int, dt: float, params):
    n_steps = int(round(T_END / dt))
    if kind == 2:
        state0 = jnp.array([-1.0, 1.0, 0.0, 0.0])
        rhs = _fhn_rhs
    else:
        state0 = jnp.array([-65.0, 0.0529, 0.5961, 0.3177])
        rhs = _hh_rhs

    def rk4(s, _):
        k1 = rhs(s, params)
        k2 = rhs(s + 0.5 * dt * k1, params)
        k3 = rhs(s + 0.5 * dt * k2, params)
        k4 = rhs(s + dt * k3, params)
        s2 = s + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        return s2, s2

    def euler(s, _):
        s2 = s + dt * rhs(s, params)
        return s2, s2

    step = euler if kind == 1 else rk4
    _, traj = jax.lax.scan(step, state0, None, length=n_steps)
    return traj  # (n_steps, 4)


def _outputs(kind: int, traj):
    V = traj[:, 0]
    n_gate = traj[:, 3]
    if kind == 2:
        # rescale FHN to HH-like voltage units so outputs correlate
        V = -65.0 + 40.0 * (V + 1.0)
        n_gate = 0.3177 + 0.1 * traj[:, 1]
    spikes = jnp.mean(jax.nn.sigmoid((V - 0.0) / 2.0))
    return jnp.stack([jnp.mean(V), V[-1], jnp.max(V), spikes,
                      jnp.mean(n_gate)])


class HodgkinHuxleyProblem(BLUEProblem):
    """12-model, 5-output neuron hierarchy (reference paper example)."""

    def __init__(self, models=DEFAULT_MODELS, **params):
        self.models = tuple(models)
        if "costs" not in params:
            # cost ~ steps * (4 rhs evals for RK4, 1 for Euler; FHN ~ 1/5)
            c = []
            for kind, dt in self.models:
                steps = T_END / dt
                work = {0: 4.0, 1: 1.0, 2: 0.8}[kind]
                c.append(steps * work)
            c = np.array(c)
            params["costs"] = c / c.min()
        super().__init__(len(self.models), n_outputs=N_OUTPUTS, **params)

    def sampler_jax(self, key, ls):
        k1, k2, k3 = jax.random.split(key, 3)
        I_app = 8.0 + 4.0 * jax.random.uniform(k1)      # 8..12 uA/cm^2
        gNa = 120.0 * (1.0 + 0.1 * jax.random.normal(k2))
        gK = 36.0 * (1.0 + 0.1 * jax.random.normal(k3))
        return jnp.stack([I_app, gNa, gK])

    def evaluate_jax(self, ls, params):
        cols = []
        for l in ls:
            kind, dt = self.models[l]
            traj = _integrate(kind, dt, params)
            cols.append(_outputs(kind, traj))
        return jnp.stack(cols, axis=1)  # (5, L)
