"""B8 (RMPPI's stage 2, both chains of each sample, the real one with the
DDP feedback in its loop) for the later pairs, on the CPU: the port's plain
version against the JAX package's ``_fused_rmppi_call`` in interpret mode on
the same inputs, K = 64, T = 8, for the zoo's analytic pairs (the cartpole,
the quadrotor with its quadratic and its map cost, the Dubins car and the DI
with ``QuadraticCost``) and the bicycle with the AutoRally cost (its sticky
crash: the one-thread B8 on the card). Tolerances (those of
test_torch_robust_entries.py): costs rtol 2e-5 / atol 1e-5, the map costs'
atol 2e-4; U_real rtol 1e-5 / atol 1e-5; crash flags exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu_torch.ops import _build
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_robust_entries import DT, LAM, ALPHA, TOL, _close, _delta, _parts
from test_torch_split_pairs import rollout_inputs

K_B8, T_B8 = 64, 8
B8_PAIRS = ("cartpole", "quadrotor_quadratic", "quadrotor_map", "dubins_quadratic",
            "di_quadratic", "bicycle_ar")


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _b8_inputs(name, seed):
    jdyn, _, _, _, x0 = _parts(name)
    S, C = jdyn.STATE_DIM, jdyn.CONTROL_DIM
    U, lr = rollout_inputs(name, K_B8, T_B8, seed)
    rng = np.random.default_rng(seed)
    gains = (-0.3 * rng.uniform(size=(T_B8, C, S))).astype(np.float32)
    sigma = (lr[1] * rng.uniform(0.8, 1.2, size=(T_B8, C))).astype(np.float32)
    coeff = np.full((C,), 0.5, np.float32)
    return x0, x0 + _delta(name, S, 0.05), U, gains, sigma, coeff


@pytest.mark.parametrize("name", B8_PAIRS)
def test_rmppi_rollout_plain_matches_jax_kernel(name, one_thread):
    """B8: both chains of each sample, the real one with the feedback."""
    jdyn, jcost, dyn, cost, _ = _parts(name)
    x_nom, x_real, U, gains, sigma, coeff = _b8_inputs(name, 21)
    jout = pallas_rollout.fused_rmppi_rollout(
        jdyn, jcost, jnp.asarray(x_nom), jnp.asarray(x_real), jnp.asarray(U),
        jnp.asarray(gains), jnp.asarray(sigma), jnp.asarray(coeff), jnp.float32(DT), LAM,
        ALPHA, interpret=True)
    tout = fr.fused_rmppi_rollout(dyn, cost, *(torch.from_numpy(a) for a in (
        x_nom, x_real, U, gains, sigma, coeff)), DT, LAM, ALPHA)
    rtol, atol = TOL.get(name, (2e-5, 1e-5))
    for what, t, j in zip(("s_nom", "j_real", "s_fb"), tout[:3], jout[:3]):
        _close(t, j, rtol, atol, what)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    _close(tout[4], jout[4], 1e-5, 1e-5, "U_real")
    assert _build.pair_entry(name, "rmppi") == (f"robust_{name}", f"rmppi_rollout_{name}")


