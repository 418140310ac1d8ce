"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU with nvcc (marker ``cuda``) and skip
without one. They import neither JAX nor the JAX package, so they run
without the repository's conftest, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch import GaussianDistribution, VanillaMPPI
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.ops import fused_rollout as fr

T, C = 24, 2
DT, LAM, ALPHA, P_PURE = 0.02, 1.3, 0.1, 0.25


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(K, dev, seed):
    rng = np.random.default_rng(seed)
    mean = rng.normal(scale=0.5, size=(T, C)).astype(np.float32)
    sigma = np.tile(np.array([[0.8, 1.3]], np.float32), (T, 1))
    U = (mean + sigma * rng.normal(size=(K, T, C))).astype(np.float32)
    thresh = float((np.float32(1) - np.float32(P_PURE)) * np.float32(K))
    lr = (torch.from_numpy(mean).to(dev), torch.from_numpy(sigma).to(dev),
          torch.tensor([0.01, 0.5], device=dev), LAM, ALPHA, thresh)
    x0 = torch.tensor([2.0, 0.05, -0.1, 1.0], device=dev)
    return x0, torch.from_numpy(U).to(dev), lr


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("with_lr", [False, True])
def test_rollout_costs_kernel_matches_plain(cuda_device, K, with_lr):
    x0, U, lr = _inputs(K, cuda_device, seed=K)
    dyn = DoubleIntegratorDynamics.create(device=cuda_device)
    cost = DoubleIntegratorCircleCost(device=cuda_device)
    lrp = lr if with_lr else None
    fr.reset_launch_counts()
    kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_kernel"] == 1
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
    _close(kc, pc, rtol=1e-5, atol=1e-6)
    assert torch.equal(kcrash, pcrash)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
def test_weighted_rollout_kernels_match_plain(cuda_device, K):
    x0, U, lr = _inputs(K, cuda_device, seed=K + 1)
    dyn = DoubleIntegratorDynamics.create(device=cuda_device)
    cost = DoubleIntegratorCircleCost(device=cuda_device)
    fr.reset_launch_counts()
    kc, kcrash, kmean, kbase, keta = fr.fused_weighted_rollout(
        dyn, cost, x0, U, DT, LAM, lr_params=lr)
    torch.cuda.synchronize()
    assert fr.launch_counts == {"rollout_costs_kernel": 1,
                                "flash_combine_kernel": 1}
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    pmean, pbase, peta = fr.flash_combine_plain(
        fr.block_carries_plain(pc, U, LAM), T, C, LAM)
    _close(kc, pc, rtol=1e-5, atol=1e-6)
    assert torch.equal(kcrash, pcrash)
    _close(kmean, pmean, rtol=1e-4, atol=1e-5)
    _close(kbase, pbase, rtol=1e-6, atol=0)
    _close(keta, peta, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_fused_solve_matches_combined_on_the_card(cuda_device):
    def build(kernel):
        return VanillaMPPI(
            DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
            GaussianDistribution.create(std_dev=[1.0, 1.0],
                                        control_cost_coeff=[0.01, 0.01]),
            num_timesteps=T, num_rollouts=300, kernel=kernel)

    fused, combined = build("fused"), build("combined")
    assert fused.device.type == "cuda"
    eps = torch.randn((300, T, C), device=cuda_device)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0], device=cuda_device)
    state = fused.init_state(seed=0)
    rf, _ = fused.solve(x, state, injected_noise=eps)
    rc, _ = combined.solve(x, state, injected_noise=eps)
    _close(rf.control_mean, rc.control_mean, rtol=1e-4, atol=1e-5)
    _close(rf.costs, rc.costs, rtol=1e-5, atol=1e-5)
    assert torch.equal(rf.crash, rc.crash)
