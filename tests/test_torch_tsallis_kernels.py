"""The Tsallis epilogue on the CPU: the plain versions of the rollout
kernel's Tsallis mode (pass 1: costs and per-block minima), of the Tsallis
reduction kernel (pass 2) and of the merge, against the JAX package's Pallas
kernels in interpret mode: the two-pass epilogue of ``_fused_call``
(``fused_weighted_rollout(weight_kind="tsallis")``) and
``_tsallis_reduce_call``. The kernels themselves are held against the same
plain versions on the card by test_torch_cuda_kernels.py and chip_smoke.py.

Tolerances: costs rtol 1e-5 / atol 1e-6 (the two sides may sum the LR term
in another order); rho exactly the port's own minimum cost, and against JAX
at the costs' tolerance; eta rtol 1e-5; new means rtol 1e-4 / atol 1e-5
(sums over samples in another order). Where the costs differ by an ulp or
two, a small gamma magnifies that in the weights: w = base^pw with base =
1 - (J - rho) / gamma moves by pw / gamma base^(pw - 1) |dJ|, so eta and the
means get that bound on top (``_weight_slack``), as the robust tests give
the softmax weights the costs' tolerance times |J| / lambda.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu.ops import weights as jweights
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import weights

T, C = 24, 2
DT, LAM, ALPHA = 0.02, 1.3, 0.2
# (gamma, r): the bench's, and the JAX suite's small gamma that zeros some
# weights (tests/test_pallas_rollout.py:581-604)
WEIGHTS = {"bench": (10.0, 2.0), "small gamma": (0.12, 2.4)}


def _inputs(K, seed=3):
    """DI samples around a constant mean with a pure-noise tail, as
    tests/test_pallas_rollout.py:581-604."""
    rng = np.random.default_rng(seed)
    mean = np.tile(np.array([[0.3, -0.2]], np.float32), (T, 1))
    U = (mean + 0.5 * rng.normal(size=(K, T, C))).astype(np.float32)
    sigma = np.tile(np.array([[1.0, 0.7]], np.float32), (T, 1))
    coeff = np.array([0.02, 0.01], np.float32)
    thresh = float(np.float32(0.75) * np.float32(K))
    return np.array([2.0, 0.0, 0.0, 1.0], np.float32), U, (mean, sigma, coeff, LAM, ALPHA,
                                                           thresh)


def _models():
    return ((JDI.create(control_ranges=[[-3, 3], [-3, 3]]), JCircle()),
            (DoubleIntegratorDynamics.create(control_ranges=[[-3, 3], [-3, 3]]),
             DoubleIntegratorCircleCost()))


def _weight_slack(costs, rho, gamma, r, dJ):
    """Sum over the samples of how far a weight may move when every cost
    (and rho) may move by ``dJ``: pw / gamma base^(pw - 1) 2 dJ."""
    pw = 1.0 / (np.float64(np.float32(r)) - 1.0)
    dj = costs.double().numpy() - float(rho)
    base = 1.0 - dj / gamma
    inside = (dj < gamma) & (base > 0)
    return float(np.sum(pw / gamma * base[inside] ** (pw - 1.0) * 2.0 * dJ))


def _close(t, j, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("weights_name", sorted(WEIGHTS))
def test_tsallis_epilogue_plain_matches_jax_kernel(K, weights_name):
    gamma, r = WEIGHTS[weights_name]
    x0, U, lr = _inputs(K)
    (jdyn, jcost), (dyn, cost) = _models()
    jlr = tuple(jnp.asarray(a) for a in lr[:3]) + tuple(jnp.float32(v) for v in lr[3:])
    tlr = tuple(torch.from_numpy(a) for a in lr[:3]) + lr[3:]
    jc, jcrash, jmean, jrho, jeta = pallas_rollout.fused_weighted_rollout(
        jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), DT, LAM, lr_params=jlr, tile_k=128,
        weight_kind="tsallis", weight_params=(jnp.float32(gamma), jnp.float32(r)))
    fr.reset_launch_counts()
    tc, tcrash, tmean, trho, teta = fr.fused_weighted_rollout(
        dyn, cost, torch.from_numpy(x0), torch.from_numpy(U), DT, LAM, lr_params=tlr,
        weight_kind="tsallis", weight_params=(gamma, r))
    assert all(v == 0 for v in fr.launch_counts.values())  # CPU: the plain versions
    _close(tc, jc, 1e-5, 1e-6, "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    assert float(trho) == float(torch.amin(tc))
    _close(trho, jrho, 1e-5, 1e-6, "rho")
    slack = _weight_slack(tc, trho, gamma, r, float(np.abs(tc.numpy() - jc).max()))
    _close(teta, jeta, 1e-5, slack, "eta")
    spread = float((torch.from_numpy(U) - tmean).abs().max())
    _close(tmean, jmean, 1e-4, 1e-5 + slack * spread / float(teta), "new mean")
    w = weights.tsallis_weights(tc, gamma, r, trho)
    if weights_name == "small gamma":
        assert bool((w == 0).any()) and int((w > 0).sum()) > 1


@pytest.mark.parametrize("K", [256, 300])
def test_pass1_block_minima(K):
    x0, U, lr = _inputs(K, seed=4)
    (_, _), (dyn, cost) = _models()
    tlr = tuple(torch.from_numpy(a) for a in lr[:3]) + lr[3:]
    costs, crash, minima = fr.rollout_block_minima(dyn, cost, torch.from_numpy(x0),
                                                    torch.from_numpy(U), DT, tlr,
                                                    split_cost=False)
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, torch.from_numpy(x0),
                                        torch.from_numpy(U), DT, tlr)
    assert torch.equal(costs, pc) and torch.equal(crash, pcrash)
    nb = -(-K // fr.BLOCK)
    assert minima.shape == (nb,)
    for b in range(nb):
        assert float(minima[b]) == float(costs[b * fr.BLOCK:(b + 1) * fr.BLOCK].min())


@pytest.mark.parametrize("K,K_valid", [(256, 256), (384, 300)])
@pytest.mark.parametrize("weights_name", sorted(WEIGHTS))
def test_reduce_plain_matches_jax_tsallis_reduce_call(K, K_valid, weights_name):
    """B5 against a given rho, as the sharded JAX epilogue calls it: U
    channel-major and padded to the 128-lane tile on the JAX side, (K, T, C)
    on the port's; samples past K_valid weigh 0."""
    gamma, r = WEIGHTS[weights_name]
    rng = np.random.default_rng(K + K_valid)
    U = rng.normal(size=(K, T, C)).astype(np.float32)
    costs = rng.uniform(1.0, 1.5, size=(K,)).astype(np.float32)
    rho = np.float32(costs[:K_valid].min())
    pw = np.float32(1.0) / (np.float32(r) - np.float32(1.0))
    scal = jnp.asarray([[rho, gamma, pw, K_valid]], jnp.float32)
    jnum, jeta = pallas_rollout._tsallis_reduce_call(
        jnp.transpose(jnp.asarray(U), (2, 1, 0)), jnp.asarray(costs), scal, T, C, 128, True)
    tnum, teta = fr.tsallis_reduce(torch.from_numpy(U), torch.from_numpy(costs),
                                   torch.tensor(rho), gamma, r, K_valid)
    _close(teta, jeta, 1e-5, 0, "eta")
    _close(tnum, jnum, 1e-5, 1e-5, "num")
    w = jweights.tsallis_weights(jnp.asarray(costs[:K_valid]), jnp.float32(gamma),
                                 jnp.float32(r), jnp.float32(rho))
    _close(teta, jnp.sum(w), 1e-5, 0, "eta vs the eager weights")


def test_nan_cost_gives_a_nan_rho_as_jax():
    """A NaN cost: jnp.min gives a NaN rho, every Tsallis weight is 0 and
    the mean 0 / 0; the port keeps those semantics (its kernel does not use
    fminf, which would drop the NaN)."""
    K = 256
    x0, U, lr = _inputs(K, seed=5)
    U[37, 5:] = np.nan
    (jdyn, jcost), (dyn, cost) = _models()
    jc, _, jmean, jrho, jeta = pallas_rollout.fused_weighted_rollout(
        jdyn, jcost, jnp.asarray(x0), jnp.asarray(U), DT, LAM, tile_k=128,
        weight_kind="tsallis", weight_params=(jnp.float32(10.0), jnp.float32(2.0)))
    tc, _, tmean, trho, teta = fr.fused_weighted_rollout(
        dyn, cost, torch.from_numpy(x0), torch.from_numpy(U), DT, LAM,
        weight_kind="tsallis", weight_params=(10.0, 2.0))
    assert np.isnan(np.asarray(jc)[37]) and bool(torch.isnan(tc[37]))
    assert np.isnan(float(jrho)) and bool(torch.isnan(trho))
    assert float(jeta) == float(teta) == 0.0
    assert np.isnan(np.asarray(jmean)).all() and bool(torch.isnan(tmean).all())
    minima = fr.block_minima_plain(tc)
    assert bool(torch.isnan(minima[0])) and not bool(torch.isnan(minima[1:]).any())


def test_tsallis_rows_merge_as_one_ordered_sum():
    """The rows (0, sum w, sum w U) merged by flash_combine (m_b = 0: every
    scale is 1) equal one weighted mean; ``with_num`` returns the sum."""
    K = 200
    rng = np.random.default_rng(6)
    U = torch.from_numpy(rng.normal(size=(K, T, C)).astype(np.float32))
    costs = torch.from_numpy(rng.uniform(0.0, 3.0, size=(K,)).astype(np.float32))
    rows, rho = fr.tsallis_block_rows(U, costs, fr.block_minima_plain(costs), 2.0, 2.4)
    assert rows.shape == (-(-K // fr.BLOCK), 2 + T * C) and bool((rows[:, 0] == 0).all())
    assert float(rho) == float(costs.min())
    mean, _, eta, num = fr.flash_combine(rows, T, C, 1.0, with_num=True)
    w = fr.tsallis_rows_plain(U[:, :1, :1].contiguous(), costs, rho, 2.0,
                              fr._tsallis_pw(2.4))[:, 1]
    w64 = weights.tsallis_weights(costs, 2.0, 2.4, rho).double()
    want = (w64[:, None, None] * U.double()).sum(0)
    _close(num, want, 1e-5, 1e-5, "num")
    _close(mean, want / w64.sum(), 1e-5, 1e-6, "mean")
    _close(eta, w64.sum(), 1e-5, 0, "eta")
    _close(w.sum(), w64.sum(), 1e-5, 0, "row sums")


def test_reduce_wrapper_checks_its_inputs():
    U = torch.zeros((64, T, C))
    costs = torch.zeros((64,))
    with pytest.raises(ValueError, match="costs"):
        fr.tsallis_block_rows(U, torch.zeros((63,)), costs[:1], 1.0, 2.0)
    with pytest.raises(ValueError, match="rho"):
        fr.tsallis_block_rows(U, costs, torch.zeros(()), 1.0, 2.0)
    with pytest.raises(ValueError, match="K_valid"):
        fr.tsallis_block_rows(U, costs, costs[:1], 1.0, 2.0, K_valid=65)
    with pytest.raises(ValueError, match="contiguous"):
        fr.tsallis_block_rows(U.transpose(1, 2), costs, costs[:1], 1.0, 2.0)
    with pytest.raises(ValueError, match="weight_kind"):
        dyn, cost = _models()[1]
        fr.fused_weighted_rollout(dyn, cost, torch.zeros(4), U, DT, LAM, weight_kind="cem")


@pytest.fixture(autouse=True)
def _fresh_jit_cache():
    yield
    jax.clear_caches()
