"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need an NVIDIA GPU with nvcc (marker ``cuda``) and skip
without one. They import neither JAX nor the JAX package, so they run
without the repository's conftest, which imports JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch import (
    DDPFeedback,
    GaussianDistribution,
    NLNDistribution,
    SmoothMPPIDistribution,
    VanillaMPPI,
)
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.feedback.ilqr import _alpha_ladder
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import fused_solve, philox, riccati

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
    assert fr.launch_counts["rollout_costs_kernel"] == 1
    assert fr.launch_counts["flash_combine_kernel"] == 1
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


@pytest.mark.cuda
@pytest.mark.parametrize("K", [144, 300])
def test_rollout_costs_kernel_per_sample_x0_matches_plain(cuda_device, K):
    x0, U, _ = _inputs(K, cuda_device, seed=K + 2)
    x0s = x0 + 0.3 * torch.randn((K, 4), device=cuda_device)
    dyn = DoubleIntegratorDynamics.create(device=cuda_device)
    cost = DoubleIntegratorCircleCost(device=cuda_device)
    fr.reset_launch_counts()
    kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0s, U, DT)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_kernel"] == 1
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0s, U, DT)
    _close(kc, pc, rtol=1e-5, atol=1e-6)
    assert torch.equal(kcrash, pcrash)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 250])
def test_rmppi_rollout_kernel_matches_plain(cuda_device, K):
    g = torch.Generator(device=cuda_device).manual_seed(K)
    dev = dict(device=cuda_device)
    dyn = DoubleIntegratorDynamics.create(
        control_ranges=[[-2.5, 2.5], [-2.0, 2.0]], control_deadband=[0.05, 0.1],
        **dev)
    cost = DoubleIntegratorCircleCost(**dev)
    U = 1.2 * torch.randn((K, T, C), generator=g, **dev)
    gains = -0.8 * torch.rand((T, C, 4), generator=g, **dev)
    sigma = 0.6 + 0.8 * torch.rand((T, C), generator=g, **dev)
    coeff = torch.tensor([0.02, 0.5], **dev)
    x_nom = torch.tensor([2.0, 0.0, 0.0, 1.0], **dev)
    x_real = torch.tensor([2.15, -0.05, 0.1, 0.9], **dev)
    args = (dyn, cost, x_nom, x_real, U, gains, sigma, coeff, DT, LAM, ALPHA)
    fr.reset_launch_counts()
    kout = fr.fused_rmppi_rollout(*args)
    torch.cuda.synchronize()
    assert fr.launch_counts["rmppi_rollout_kernel"] == 1
    pout = fr.rmppi_rollout_plain(*args)
    for k, p in zip(kout[:3], pout[:3]):
        _close(k, p, rtol=1e-5, atol=1e-6)
    assert torch.equal(kout[3], pout[3])
    _close(kout[4], pout[4], rtol=0, atol=0)


def _linearisation(dev, T_=T):
    """ilqr_tracking's inputs to the ladder on a DI tracking problem."""
    g = torch.Generator(device=dev).manual_seed(T_)
    dyn = DoubleIntegratorDynamics.create(control_ranges=[[-1.5, 1.5], [-1.0, 1.0]],
                                          device=dev)
    S = 4
    eye = torch.eye(S, device=dev)
    J = torch.zeros((S, S), device=dev)
    J[0, 2] = J[1, 3] = 1.0
    B = torch.zeros((S, C), device=dev)
    B[2, 0] = B[3, 1] = 1.0
    xs = torch.tensor([2.0, 0.0, 0.0, 1.0], device=dev) + 0.1 * torch.randn(
        (T_, S), generator=g, device=dev)
    us = 0.5 * torch.randn((T_, C), generator=g, device=dev)
    goal_x = xs + 0.1 * torch.randn((T_, S), generator=g, device=dev)
    Q, R, Qf = eye, 0.5 * torch.eye(C, device=dev), 3 * eye
    return dyn, dict(
        As=(J * DT + eye).expand(T_, S, S).contiguous(),
        Bs=(B * DT).expand(T_, S, C).contiguous(),
        dLx=(xs - goal_x) @ Q.T, dLu=us @ R.T, Q=Q, R=R, Q_f=Qf,
        Vxx_T=0.5 * (Qf + Qf.T), Vx_T=Qf @ (xs[-1] - goal_x[-1]), xs=xs, us=us,
        goal_x=goal_x, goal_u=torch.zeros((T_, C), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("T_", [24, 50])
def test_riccati_kernels_match_plain(cuda_device, T_):
    dyn, p = _linearisation(cuda_device, T_)
    back = [p[n] for n in ("As", "Bs", "dLx", "dLu", "Q", "R", "Vxx_T", "Vx_T")]
    riccati.reset_launch_counts()
    kK, kk = riccati.riccati_backward(*back, DT)
    Qdt, Rdt = p["Q"] * DT, p["R"] * DT
    pK, pk = riccati.riccati_backward_plain(*back[:4], Qdt, Rdt, *back[6:], DT, 1e-6)
    alphas = _alpha_ladder(device=cuda_device)
    lo, hi = dyn.control_ranges[:, 0].contiguous(), dyn.control_ranges[:, 1].contiguous()
    kout = riccati.riccati_ladder_solve(
        dyn, p["xs"], p["us"], *back[:4], p["Q"], p["R"], p["Q_f"], p["Vxx_T"],
        p["Vx_T"], p["goal_x"], p["goal_u"], alphas, lo, hi, DT)
    torch.cuda.synchronize()
    assert riccati.launch_counts["riccati_backward_kernel"] == 1
    assert riccati.launch_counts["riccati_ladder_kernel"] == 1
    ulim = torch.stack([lo, hi])
    pcost, pxs, pus = riccati.ladder_forward_plain(
        dyn, p["xs"], p["us"], pK, pk, p["goal_x"], p["goal_u"], p["Q"], p["R"],
        p["Q_f"], alphas, ulim, DT)
    for got, want in ((kK, pK), (kk, pk), (kout[0], pK), (kout[1], pk),
                      (kout[2], pcost), (kout[3], pxs), (kout[4], pus)):
        _close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_ddp_feedback_kernel_matches_scan_on_the_card(cuda_device):
    dyn, p = _linearisation(cuda_device)
    x0 = p["xs"][0]
    fb_k = DDPFeedback.create(dyn, DT)
    fb_s = DDPFeedback.create(dyn, DT, use_kernel=False)
    gk = fb_k.compute_feedback(x0, p["goal_x"], p["us"])
    gs = fb_s.compute_feedback(x0, p["goal_x"], p["us"])
    _close(gk.gains, gs.gains, rtol=1e-4, atol=1e-5)
    _close(gk.x_traj, gs.x_traj, rtol=1e-4, atol=1e-5)


def _sampler(kind, dev, T_=T):
    kw = dict(std_dev=[0.8, 1.3], control_cost_coeff=[0.01, 0.5],
              pure_noise_percentage=P_PURE, device=dev)
    if kind == "nln":
        return NLNDistribution.create(**kw)
    if kind == "smooth":
        return SmoothMPPIDistribution.create(num_timesteps=T_, dt=0.05, **kw)
    return GaussianDistribution.create(**kw)


def _fused_inputs(kind, K, dev, inject):
    g = torch.Generator(device=dev).manual_seed(K)
    dyn = DoubleIntegratorDynamics.create(control_ranges=[[-1.5, 1.5], [-1.0, 1.0]],
                                          control_deadband=[0.02, 0.0], device=dev)
    cost = DoubleIntegratorCircleCost(device=dev)
    mean = 0.5 * torch.randn((T, C), generator=g, device=dev)
    seed = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32, device=dev)
    z = None
    if inject:
        n_z = 2 if kind == "nln" else 1
        z = torch.randn((n_z, K, T, C), generator=g, device=dev)
    x0 = torch.tensor([2.0, 0.05, -0.1, 1.0], device=dev)
    return dyn, cost, _sampler(kind, dev), x0, mean, seed, z


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("kind", ["gaussian", "nln"])
@pytest.mark.parametrize("inject", [False, True])
def test_fused_solve_kernel_matches_plain(cuda_device, K, kind, inject):
    dyn, cost, samp, x0, mean, seed, z = _fused_inputs(kind, K, cuda_device, inject)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    kw = dict(iteration=1, optimization_stride=2, injected_noise=z)
    fr.reset_launch_counts()
    kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, **kw)
    torch.cuda.synchronize()
    assert fr.launch_counts["fused_solve_kernel"] == 1
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, **kw)
    _close(kU, pU, rtol=1e-5, atol=1e-6)
    _close(kc, pc, rtol=1e-5, atol=1e-6)
    assert torch.equal(kcrash, pcrash)
    _close(kcarry, pcarry, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("kind,epilogue", [("gaussian", False), ("nln", False),
                                           ("smooth", False), ("smooth", True)])
def test_fused_sample_rollout_kernel_matches_plain(cuda_device, K, kind, epilogue):
    dyn, cost, samp, x0, mean, seed, _ = _fused_inputs(kind, K, cuda_device, False)
    state = 0.3 * torch.ones((T, C), device=cuda_device) if kind == "smooth" else None
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    kw = dict(iteration=0, optimization_stride=1, sampler_state=state)
    fr.reset_launch_counts()
    kout = fr.fused_sample_rollout_costs(*args, epilogue=epilogue, **kw)
    torch.cuda.synchronize()
    assert fr.launch_counts["fused_sample_rollout_kernel"] == 1
    pc, pcrash, pU, pW = fr.sample_rollout_plain(*args, **kw)
    _close(kout[0], pc, rtol=1e-5, atol=1e-6)
    assert torch.equal(kout[1], pcrash)
    _close(kout[2], pU, rtol=1e-5, atol=1e-6)
    if epilogue:
        pm, pb, pe = fr.flash_combine_plain(fr.block_carries_plain(pc, pW, LAM), T, C, LAM)
        _close(kout[3], pm, rtol=1e-4, atol=1e-5)
        _close(kout[4], pb, rtol=1e-6, atol=0)
        _close(kout[5], pe, rtol=1e-5, atol=0)
    elif kind == "smooth":
        _close(kout[3], pW, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_kernel_draw_equals_the_plain_philox(cuda_device):
    """Zero mean, unit sigma, no constraints: the sampling kernel's U is its
    raw Philox draw, which must equal ops/philox.py's."""
    K = 1000
    dyn = DoubleIntegratorDynamics.create(device=cuda_device)
    cost = DoubleIntegratorCircleCost(device=cuda_device)
    samp = GaussianDistribution.create(std_dev=[1.0, 1.0], device=cuda_device)
    seed = torch.tensor(2024, dtype=torch.int32, device=cuda_device)
    x0 = torch.tensor([2.0, 0.0, 0.0, 1.0], device=cuda_device)
    _, _, U, _ = fr.fused_sample_rollout_costs(
        dyn, cost, samp, x0, torch.zeros((T, C), device=cuda_device), seed, DT, LAM,
        ALPHA, K)
    z = philox.normals(seed, K, T, C)[0]
    _close(U[1:], z[1:], rtol=0, atol=0)
