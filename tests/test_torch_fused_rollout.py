"""Parity of the port's fused rollout (the plain versions of its CUDA
kernels, which the wrappers run for CPU tensors) with the JAX package's
Pallas kernel in interpret mode. The kernels themselves are held against
the same plain versions on the card by test_torch_cuda_kernels.py and
chip_smoke.py.

Tolerances: costs rtol 1e-5 / atol 1e-6 because the two sides sum in
another order (JAX may pick its split-cost variant); crash exactly; the
weighted mean and eta rtol 1e-5 / atol 1e-6; the baseline rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu.ops.rollout import rollout_combined as j_rollout_combined
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.ops import _build, fused_rollout as fr
from mppi_generic_tpu_torch.ops.rollout import rollout_combined

T, C = 24, 2
DT, LAM, ALPHA, P_PURE = 0.02, 1.3, 0.1, 0.25


def _inputs(K, seed=0):
    rng = np.random.default_rng(seed)
    x0 = np.array([2.0, 0.05, -0.1, 1.0], np.float32)
    mean = rng.normal(scale=0.5, size=(T, C)).astype(np.float32)
    sigma = np.tile(np.array([[0.8, 1.3]], np.float32), (T, 1))
    U = (mean + sigma * rng.normal(size=(K, T, C))).astype(np.float32)
    coeff = np.array([0.01, 0.5], np.float32)
    thresh = float((np.float32(1) - np.float32(P_PURE)) * np.float32(K))
    return x0, U, (mean, sigma, coeff, LAM, ALPHA, thresh)


def _jax_lr(lr):
    mean, sigma, coeff, lam, alpha, thresh = lr
    return (jnp.asarray(mean), jnp.asarray(sigma), jnp.asarray(coeff),
            jnp.float32(lam), jnp.float32(alpha), jnp.float32(thresh))


def _torch_lr(lr):
    mean, sigma, coeff, lam, alpha, thresh = lr
    return (torch.from_numpy(mean), torch.from_numpy(sigma),
            torch.from_numpy(coeff), lam, alpha, thresh)


def _close(t, j, rtol, atol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol)


@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("with_lr", [False, True])
def test_fused_rollout_costs_matches_pallas(K, with_lr):
    x0, U, lr = _inputs(K)
    fr.reset_launch_counts()
    jc, jcrash = pallas_rollout.fused_rollout_costs(
        JDI.create(), JCircle(), jnp.asarray(x0), jnp.asarray(U), DT,
        lr_params=_jax_lr(lr) if with_lr else None)
    tc, tcrash = fr.fused_rollout_costs(
        DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
        torch.from_numpy(x0), torch.from_numpy(U), DT,
        lr_params=_torch_lr(lr) if with_lr else None)
    _close(tc, jc, rtol=1e-5, atol=1e-6)
    assert np.array_equal(tcrash.numpy(), np.asarray(jcrash))
    assert fr.launch_counts["rollout_costs_kernel"] == 0  # CPU: no launch


@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("with_lr", [False, True])
def test_fused_weighted_rollout_matches_pallas(K, with_lr):
    x0, U, lr = _inputs(K, seed=1)
    jc, jcrash, jmean, jbase, jeta = pallas_rollout.fused_weighted_rollout(
        JDI.create(), JCircle(), jnp.asarray(x0), jnp.asarray(U), DT, LAM,
        lr_params=_jax_lr(lr) if with_lr else None)
    tc, tcrash, tmean, tbase, teta = fr.fused_weighted_rollout(
        DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
        torch.from_numpy(x0), torch.from_numpy(U), DT, LAM,
        lr_params=_torch_lr(lr) if with_lr else None)
    _close(tc, jc, rtol=1e-5, atol=1e-6)
    assert np.array_equal(tcrash.numpy(), np.asarray(jcrash))
    _close(tmean, jmean, rtol=1e-5, atol=1e-6)
    _close(teta, jeta, rtol=1e-5, atol=1e-6)
    _close(tbase, jbase, rtol=1e-6, atol=0)


def test_rollout_combined_matches_jax():
    x0, U, _ = _inputs(100, seed=2)
    jc, jY, jcrash = j_rollout_combined(JDI.create(), JCircle(), jnp.asarray(x0),
                                        jnp.asarray(U), DT)
    tc, tY, tcrash = rollout_combined(
        DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
        torch.from_numpy(x0), torch.from_numpy(U), DT)
    _close(tc, jc, rtol=1e-5, atol=1e-6)
    _close(tY, jY, rtol=1e-5, atol=1e-6)
    assert np.array_equal(tcrash.numpy(), np.asarray(jcrash))


def test_fused_plain_matches_eager_oracle():
    """The plain kernel version and the eager oracle plus the sampler-style
    LR term agree: the rollout math is the same, only the LR sum order
    differs."""
    x0, U, lr = _inputs(300, seed=3)
    dyn, cost = DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost()
    fc, fcrash = fr.rollout_costs_plain(dyn, cost, torch.from_numpy(x0),
                                        torch.from_numpy(U), DT, _torch_lr(lr))
    mean, sigma, coeff, lam, alpha, thresh = _torch_lr(lr)
    pure = (torch.arange(300, dtype=torch.float32) >= thresh)[:, None, None]
    mu = torch.where(pure, 0.0, mean[None].expand(300, T, C))
    Ut = torch.from_numpy(U)
    lr_cost = 0.5 * lam * (1 - alpha) * torch.sum(
        coeff * mu * (mu - 2 * Ut) / (sigma * sigma), dim=(1, 2))
    ec, _, ecrash = rollout_combined(dyn, cost, torch.from_numpy(x0), Ut, DT)
    _close(fc, ec + lr_cost / T, rtol=1e-5, atol=1e-5)
    assert torch.equal(fcrash, ecrash)


@pytest.mark.parametrize("K", [64, 200, 257])
def test_block_carries_and_flash_combine_match_global_softmax(K):
    """Per-block carries (ragged last block) merged by flash_combine equal
    one global softmax-weighted mean."""
    rng = np.random.default_rng(K)
    costs = rng.uniform(0.5, 40.0, size=(K,)).astype(np.float32)
    U = rng.normal(size=(K, T, C)).astype(np.float32)
    carry = fr.block_carries_plain(torch.from_numpy(costs), torch.from_numpy(U), LAM)
    assert carry.shape == (-(-K // fr.BLOCK), 2 + T * C)
    new_mean, baseline, eta = fr.flash_combine(carry, T, C, LAM)
    s = -costs.astype(np.float64) / LAM
    w = np.exp(s - s.max())
    want = np.tensordot(w / w.sum(), U.astype(np.float64), axes=(0, 0))
    _close(new_mean, want, rtol=1e-5, atol=1e-6)
    _close(baseline, costs.min(), rtol=1e-6, atol=0)
    _close(eta, w.sum(), rtol=1e-5, atol=0)


def test_wrappers_refuse_what_the_kernel_does_not_take():
    x0, U, lr = _inputs(64)
    dyn, cost = DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost()
    x0_t, U_t = torch.from_numpy(x0), torch.from_numpy(U)

    class OtherCost(DoubleIntegratorCircleCost):
        pass

    with pytest.raises(NotImplementedError):
        fr._check_rollout_inputs(dyn, OtherCost(), x0_t, U_t, None)
    with pytest.raises(ValueError, match="not supported"):
        fr.fused_rollout_costs(dyn, cost, x0_t, U_t.to("meta"), DT)
    with pytest.raises(ValueError, match="contiguous"):
        fr._check_rollout_inputs(dyn, cost, x0_t, U_t.transpose(0, 1), None)
    with pytest.raises(TypeError):
        fr._check_rollout_inputs(dyn, cost, x0_t, U_t.double(), None)
    with pytest.raises(ValueError, match="x0"):
        fr._check_rollout_inputs(dyn, cost, x0_t[:3].contiguous(), U_t, None)
    bad_lr = (torch.zeros(T + 1, C),) + _torch_lr(lr)[1:]
    with pytest.raises(ValueError, match="lr_params"):
        fr._check_rollout_inputs(dyn, cost, x0_t, U_t, bad_lr)


def test_build_is_keyed_by_sources_and_needs_nvcc(monkeypatch, tmp_path):
    assert _build._source_hash() == _build._source_hash()
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "Path", lambda p: tmp_path / "missing")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build._nvcc()
