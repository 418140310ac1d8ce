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
    ColoredMPPI,
    ColoredNoiseDistribution,
    DDPFeedback,
    GaussianDistribution,
    NLNDistribution,
    RobustMPPI,
    SmoothMPPIDistribution,
    TubeMPPI,
    VanillaMPPI,
)
from mppi_generic_tpu_torch.costs import (
    ARRobustCost,
    ARStandardCost,
    CartpoleQuadraticCost,
    DoubleIntegratorCircleCost,
    DoubleIntegratorRobustCost,
    QuadraticCost,
    QuadrotorMapCost,
    QuadrotorQuadraticCost,
)
from mppi_generic_tpu_torch.feedback.ilqr import _alpha_ladder, linearize
from mppi_generic_tpu_torch.maps import MapTexture2D
from mppi_generic_tpu_torch.models import (
    AutorallyNNDynamics,
    BicycleSlipDynamics,
    BicycleSlipParametricElevation,
    CartpoleDynamics,
    DoubleIntegratorDynamics,
    DubinsDynamics,
    QuadrotorDynamics,
    RacerDubinsDynamics,
    RacerDubinsElevationDynamics,
    RacerDubinsElevationLSTMSteering,
    RacerDubinsElevationLSTMUncertainty,
    RacerDubinsElevationSuspension,
    RacerSuspensionDynamics,
)
from mppi_generic_tpu_torch.nn import FNN, LSTM
from mppi_generic_tpu_torch.ops import _build
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import fused_solve, philox, riccati
from mppi_generic_tpu_torch.utils.math_utils import true_div

T, C = 24, 2
DT, LAM, ALPHA, P_PURE = 0.02, 1.3, 0.1, 0.25
LAM_AR = 1.0  # the controllers' default lambda


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
    kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp, split_cost=False)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_staged_kernel"] == 1
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
        dyn, cost, x0, U, DT, LAM, lr_params=lr, split_cost=False)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_staged_kernel"] == 1
    assert fr.launch_counts["flash_combine_tiled_kernel"] == 1
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
            num_timesteps=T, num_rollouts=300, kernel=kernel, split_cost=False)

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
    # the combined kernel (AUTO takes the split form for this pair's B1-x0)
    kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0s, U, DT, split_cost=False)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_staged_kernel"] == 1
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
    assert fr.launch_counts["rmppi_rollout_staged_kernel"] == 1
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
    assert riccati.launch_counts["riccati_backward_warp_kernel"] == 1
    assert riccati.launch_counts["riccati_ladder_warp_kernel"] == 1
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
    assert fr.launch_counts["fused_solve_staged_kernel"] == 1
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
    assert fr.launch_counts["fused_sample_rollout_staged_kernel"] == 1
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


# --- AutoRally: the FNN step (B10) and the costmap query (B9) in B1 and B3 ---
def _ar_map(kind, dev):
    """A 128^2 map as bench.py:641-644 (abs normal, seed 0, 1 m texels);
    a channel-major 4-channel map (0.1 m texels) whose channel 0 is the
    track; or no map."""
    rng = np.random.default_rng(0)
    if kind == "plain":
        return MapTexture2D(np.abs(rng.normal(size=(128, 128))).astype("f"),
                            origin=(-64, -64, 0), resolution=1.0, device=dev)
    if kind == "channel_major":
        chw = rng.normal(size=(4, 256, 256)).astype("f")
        chw[0] = 0.5 * np.abs(chw[0])
        return MapTexture2D(chw, origin=(-12.8, -12.8, 0), resolution=0.1,
                            channel_major=True, device=dev)
    return None


def _ar_parts(dev, map_kind, robust=False, seed=0):
    dyn = AutorallyNNDynamics.create(seed=seed, device=dev)
    cls = ARRobustCost if robust else ARStandardCost
    return dyn, cls(costmap=_ar_map(map_kind, dev), device=dev)


def _ar_x0(dev):
    return torch.tensor([0.0, 0.0, 0.3, 0.0, 3.0, 0.0, 0.0], device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("map_kind", ["plain", "channel_major", "none"])
@pytest.mark.parametrize("epilogue,with_lr", [(False, False), (False, True),
                                              (True, True)])
def test_ar_rollout_kernel_matches_plain(cuda_device, K, map_kind, epilogue, with_lr):
    dyn, cost = _ar_parts(cuda_device, map_kind, robust=map_kind == "none")
    g = torch.Generator(device=cuda_device).manual_seed(K)
    mean = 0.2 * torch.randn((T, C), generator=g, device=cuda_device)
    sigma = torch.tensor([[0.3, 0.5]], device=cuda_device).expand(T, C).contiguous()
    U = (mean + sigma * torch.randn((K, T, C), generator=g, device=cuda_device)).contiguous()
    lr = (mean, sigma, torch.tensor([1.0, 1.0], device=cuda_device), LAM, ALPHA,
          0.9 * K) if with_lr else None
    x0 = _ar_x0(cuda_device)
    fr.reset_launch_counts()
    if epilogue:
        kc, kcrash, kcarry = fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lr,
                                                      split_cost=False)
    else:
        kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lr, split_cost=False)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_warp_kernel"] == 1
    assert fr.launch_counts["block_carry_tiled_kernel"] == int(epilogue)
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    _close(kc, pc, rtol=1e-5, atol=1e-6)
    assert torch.equal(kcrash, pcrash)
    if epilogue:
        _close(kcarry, fr.block_carries_plain(pc, U, LAM), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ar_rollout_kernel_per_sample_x0_matches_plain(cuda_device):
    dyn, cost = _ar_parts(cuda_device, "plain")
    K = 200
    g = torch.Generator(device=cuda_device).manual_seed(7)
    U = 0.4 * torch.randn((K, T, C), generator=g, device=cuda_device)
    x0s = (_ar_x0(cuda_device) + 0.2 * torch.randn((K, 7), generator=g,
                                                    device=cuda_device)).contiguous()
    kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0s, U, DT, split_cost=False)
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0s, U, DT)
    _close(kc, pc, rtol=1e-5, atol=1e-6)
    assert torch.equal(kcrash, pcrash)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("kind", ["gaussian", "nln"])
@pytest.mark.parametrize("map_kind", ["plain", "channel_major"])
def test_ar_fused_solve_kernel_matches_plain(cuda_device, K, kind, map_kind):
    dyn, cost = _ar_parts(cuda_device, map_kind, robust=kind == "nln")
    g = torch.Generator(device=cuda_device).manual_seed(K + 1)
    kw = dict(std_dev=[0.3, 0.5], pure_noise_percentage=0.1, device=cuda_device)
    samp = NLNDistribution.create(**kw) if kind == "nln" else GaussianDistribution.create(**kw)
    mean = 0.2 * torch.randn((T, C), generator=g, device=cuda_device)
    seed = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32,
                         device=cuda_device)
    args = (dyn, cost, samp, _ar_x0(cuda_device), mean, seed, DT, LAM, ALPHA, K)
    kw = dict(iteration=0, optimization_stride=2)
    fr.reset_launch_counts()
    kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, split_cost=False, **kw)
    torch.cuda.synchronize()
    assert fr.launch_counts["fused_solve_warp_kernel"] == 1
    assert fr.launch_counts["block_carry_tiled_kernel"] == 1
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, **kw)
    _close(kU, pU, rtol=0, atol=0)
    _close(kc, pc, rtol=1e-5, atol=1e-6)
    assert torch.equal(kcrash, pcrash)
    _close(kcarry, pcarry, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ar_kernels_refuse_what_they_are_not_built_for(cuda_device):
    x0, U = _ar_x0(cuda_device), torch.zeros((64, T, C), device=cuda_device)
    wide = AutorallyNNDynamics(FNN.create([6, 16, 4], seed=1), device=cuda_device)
    _, cost = _ar_parts(cuda_device, "plain")
    with pytest.raises(NotImplementedError, match="6, 32, 32, 4"):
        fr.fused_rollout_costs(wide, cost, x0, U, DT)
    dyn = AutorallyNNDynamics.create(seed=1, device=cuda_device)
    moved = ARStandardCost(output_indices=(1, 0, 2, 3, 4, 5), device=cuda_device)
    with pytest.raises(NotImplementedError, match="output"):
        fr.fused_rollout_costs(dyn, moved, x0, U, DT)
    # the RMPPI kernel has the bicycle's entry too (its sticky cost: the
    # one-thread form), equal to its plain version
    bicycle = BicycleSlipDynamics.create(device=cuda_device)
    xb = torch.zeros((bicycle.STATE_DIM,), device=cuda_device)
    bcost = ARStandardCost(output_indices=(0, 1, 2, 8, 5, 6), device=cuda_device)
    Ub = 0.3 * torch.randn((64, T, C), generator=torch.Generator(device=cuda_device)
                           .manual_seed(5), device=cuda_device)
    args = (bicycle, bcost, xb, xb + 0.05, Ub,
            -0.1 * torch.ones((T, C, bicycle.STATE_DIM), device=cuda_device),
            torch.ones((T, C), device=cuda_device), torch.ones((C,), device=cuda_device),
            DT, LAM, ALPHA)
    fr.reset_launch_counts()
    kout = fr.fused_rmppi_rollout(*args)
    pout = fr.rmppi_rollout_plain(*args)
    torch.cuda.synchronize()
    assert fr.entry_counts == {"rmppi_rollout_bicycle_ar": 1}
    assert fr.launch_counts["rmppi_rollout_kernel"] == 1
    for k, p in zip(kout, pout):
        assert torch.equal(k, p)


def mean_tolerance(rf, rc, U, lam):
    """How far two weighted means may sit apart when their costs differ by
    dJ (sums taken in another order): a weight moves by at most 2 max|dJ| /
    lambda relative, so the mean by that times max|U_k - mean|, plus 1e-5."""
    dJ = float((rf.costs - rc.costs).abs().max())
    spread = float((U - rc.control_mean).abs().max())
    return 2 * dJ / lam * spread + 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "fused_solve"])
def test_ar_vanilla_kernels_match_combined_on_the_card(cuda_device, kernel):
    """A mild map (0.3 |z|, few crashes): costs of about 100, where the
    eager network's matmul and the kernels' left-to-right sums leave the
    costs an ulp apart."""
    def build(k):
        dyn = AutorallyNNDynamics.create(seed=0)
        tex = MapTexture2D(0.3 * np.abs(np.random.default_rng(1).normal(
            size=(64, 64))).astype("f"), origin=(-32, -32, 0))
        return VanillaMPPI(dyn, ARStandardCost(costmap=tex),
                           GaussianDistribution.create(std_dev=[0.3, 0.5]),
                           num_timesteps=T, num_rollouts=300, kernel=k, split_cost=False,
                           return_samples=True)

    ctrl, combined = build(kernel), build("combined")
    eps = torch.randn((300, T, C), device=cuda_device)
    state = ctrl.init_state(seed=0)
    rf, _ = ctrl.solve(_ar_x0(cuda_device), state, injected_noise=eps)
    rc, _ = combined.solve(_ar_x0(cuda_device), state, injected_noise=eps)
    _close(rf.costs, rc.costs, rtol=1e-5, atol=1e-4)
    assert torch.equal(rf.crash, rc.crash)
    tol = mean_tolerance(rf, rc, rc.sampled_controls, LAM_AR)
    _close(rf.control_mean, rc.control_mean, rtol=0, atol=tol)
    assert tol < 1e-3


# --- the Tsallis epilogue (B1 Tsallis mode, B5, the merge) and the bicycle entry ---
@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("gamma,r", [(10.0, 2.0), (0.12, 2.4)])
def test_tsallis_kernels_match_plain(cuda_device, K, gamma, r):
    x0, U, lr = _inputs(K, cuda_device, seed=K + 5)
    dyn = DoubleIntegratorDynamics.create(device=cuda_device)
    cost = DoubleIntegratorCircleCost(device=cuda_device)
    fr.reset_launch_counts()
    kc, kcrash, kmin = fr.rollout_block_minima(dyn, cost, x0, U, DT, lr, split_cost=False)
    krows, krho = fr.tsallis_block_rows(U, kc, kmin, gamma, r)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_staged_kernel"] == 1
    assert fr.launch_counts["tsallis_reduce_tiled_kernel"] == 1
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    assert torch.equal(kmin, fr.block_minima_plain(pc))
    assert float(krho) == float(pc.min())
    prows = fr.tsallis_rows_plain(U, pc, pc.min(), fr._f32(gamma), fr._tsallis_pw(r))
    _close(krows, prows, rtol=0, atol=0)
    fr.reset_launch_counts()
    _, _, kmean, kbase, keta = fr.fused_weighted_rollout(
        dyn, cost, x0, U, DT, LAM, lr_params=lr, weight_kind="tsallis",
        weight_params=(gamma, r), split_cost=False)
    torch.cuda.synchronize()
    assert {k: v for k, v in fr.launch_counts.items() if v} == {
        "rollout_costs_staged_kernel": 1, "tsallis_reduce_tiled_kernel": 1,
        "flash_combine_tiled_kernel": 1}
    pmean, _, peta = fr.flash_combine_plain(prows, T, C, 1.0)
    _close(kmean, pmean, rtol=1e-4, atol=1e-5)
    _close(keta, peta, rtol=1e-5, atol=0)
    assert float(kbase) == float(pc.min())


@pytest.mark.cuda
def test_tsallis_reduce_takes_a_device_rho(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    U = torch.randn((384, T, C), generator=g, device=cuda_device)
    costs = 1.0 + torch.rand((384,), generator=g, device=cuda_device)
    rho = costs[:300].min()
    fr.reset_launch_counts()
    num, eta = fr.tsallis_reduce(U, costs, rho, 0.5, 2.4, 300)
    torch.cuda.synchronize()
    assert fr.launch_counts["tsallis_reduce_tiled_kernel"] == 1
    rows = fr.tsallis_rows_plain(U, costs, rho, fr._f32(0.5), fr._tsallis_pw(2.4), 300)
    _, _, peta, pnum = fr.flash_combine_plain(rows, T, C, 1.0, with_num=True)
    _close(num, pnum, rtol=1e-5, atol=1e-5)
    _close(eta, peta, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_tsallis_kernels_keep_a_nan_rho(cuda_device):
    x0, U, lr = _inputs(256, cuda_device, seed=9)
    U[37, 5:] = float("nan")
    dyn = DoubleIntegratorDynamics.create(device=cuda_device)
    cost = DoubleIntegratorCircleCost(device=cuda_device)
    kc, _, kmean, krho, keta = fr.fused_weighted_rollout(
        dyn, cost, x0, U, DT, LAM, lr_params=lr, weight_kind="tsallis",
        weight_params=(10.0, 2.0), split_cost=False)
    assert bool(torch.isnan(kc[37])) and bool(torch.isnan(krho))
    assert float(keta) == 0.0 and bool(torch.isnan(kmean).all())


def _bicycle_parts(dev):
    rng = np.random.default_rng(0)
    tex = MapTexture2D(np.abs(rng.normal(size=(128, 128))).astype("f"),
                       origin=(-64, -64, 0), resolution=1.0, device=dev)
    return (BicycleSlipDynamics.create(device=dev),
            ARStandardCost(costmap=tex, output_indices=(0, 1, 2, 8, 5, 6), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("mode", ["costs", "costs+lr", "epilogue+lr", "tsallis+lr"])
def test_bicycle_rollout_kernel_matches_plain(cuda_device, K, mode):
    dyn, cost = _bicycle_parts(cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(K)
    mean = 0.2 * torch.randn((T, C), generator=g, device=cuda_device)
    sigma = torch.tensor([[0.3, 0.5]], device=cuda_device).expand(T, C).contiguous()
    U = (mean + sigma * torch.randn((K, T, C), generator=g, device=cuda_device)).contiguous()
    lr = ((mean, sigma, torch.tensor([1.0, 1.0], device=cuda_device), LAM_AR, ALPHA,
           0.9 * K) if mode.endswith("+lr") else None)
    x0 = torch.zeros(10, device=cuda_device)
    x0[5] = 3.0
    fr.reset_launch_counts()
    if mode.startswith("costs"):
        kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lr, split_cost=False)
    elif mode.startswith("epilogue"):
        kc, kcrash, kout = fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM_AR, lr,
                                                    split_cost=False)
    else:
        kc, kcrash, kout = fr.rollout_block_minima(dyn, cost, x0, U, DT, lr,
                                                   split_cost=False)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_staged_kernel"] == 1
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    if mode.startswith("epilogue"):
        _close(kout, fr.block_carries_plain(pc, U, LAM_AR), rtol=1e-5, atol=1e-5)
    elif mode.startswith("tsallis"):
        assert torch.equal(kout, fr.block_minima_plain(pc))


@pytest.mark.cuda
@pytest.mark.parametrize("transform", ["exp", "tsallis"])
def test_colored_fused_matches_combined_on_the_card(cuda_device, transform):
    def build(kernel):
        return ColoredMPPI(
            DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
            ColoredNoiseDistribution.create(exponents=[1.0, 2.0], std_dev=[1.0, 1.0]),
            num_timesteps=T, num_rollouts=300, kernel=kernel, weight_transform=transform,
            tsallis_gamma=10.0, tsallis_r=2.0, split_cost=False)

    fused, combined = build("fused"), build("combined")
    assert fused.device.type == "cuda"
    z = torch.randn((2, 300, C, T + 1), device=cuda_device)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0], device=cuda_device)
    state = fused.init_state(seed=0)
    rf, _ = fused.solve(x, state, injected_noise=z)
    rc, _ = combined.solve(x, state, injected_noise=z)
    _close(rf.costs, rc.costs, rtol=1e-5, atol=1e-5)
    assert torch.equal(rf.crash, rc.crash)
    _close(rf.control_mean, rc.control_mean, rtol=1e-4, atol=1e-5)
    _close(rf.baseline, rc.baseline, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_combined_divides_as_the_kernels(cuda_device):
    """The eager (combined) path divides by device scalars, as the kernels:
    at lambda 0.3 and T = 100, whose reciprocals are inexact, its costs equal
    the rollout kernel's to the last bit (a zero mean makes the LR term 0 on
    both paths) and its weights equal exp(-(J - baseline) / lambda) with a
    true division."""
    K, T_, lam = 512, 100, 0.3
    ctrl = VanillaMPPI(DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                       GaussianDistribution.create(std_dev=[1.0, 1.0],
                                                   control_cost_coeff=[0.01, 0.01]),
                       lam=lam, num_timesteps=T_, num_rollouts=K, kernel="combined",
                       return_samples=True)
    eps = torch.randn((K, T_, C), generator=torch.Generator(device=cuda_device).manual_seed(3),
                      device=cuda_device)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0], device=cuda_device)
    res, _ = ctrl.solve(x, ctrl.init_state(seed=0), injected_noise=eps)
    U = res.sampled_controls.contiguous()
    lr = (torch.zeros((T_, C), device=cuda_device), ctrl.sampler._sigma(T_, 0).contiguous(),
          ctrl.sampler.control_cost_coeff, lam, 0.0, ctrl.sampler.pure_threshold(K))
    kc, kcrash = fr.fused_rollout_costs(ctrl.dynamics, ctrl.cost, x, U, ctrl.dt, lr,
                                        split_cost=False)
    torch.cuda.synchronize()
    assert torch.equal(res.costs, kc)
    assert torch.equal(res.crash, kcrash)
    want = torch.exp(-(res.costs - res.baseline) / torch.tensor(lam, device=cuda_device))
    assert torch.equal(res.weights, want)


# --- the analytic model zoo: cartpole, quadrotor, Dubins, DI + QuadraticCost
def _zoo_parts(pair, dev):
    """(dynamics, cost, x0, std, mean offset) of one zoo pair at a test size."""
    if pair == "cartpole":
        return (CartpoleDynamics.create(control_ranges=[[-5.0, 5.0]], device=dev),
                CartpoleQuadraticCost(coeffs=[100.0, 10.0, 200.0, 20.0],
                                      terminal_cost_coeff=0.5, device=dev),
                torch.tensor([0.1, 0.0, 0.3, 0.0], device=dev), [5.0], 0.0)
    if pair.startswith("quadrotor"):
        dyn = QuadrotorDynamics.create(control_ranges=[[-3.0, 3.0]] * 3 + [[0.0, 20.0]],
                                       device=dev)
        x0 = torch.zeros(13, device=dev)
        x0[6], x0[0], x0[1] = 1.0, 0.8, -0.3
        if pair == "quadrotor_quadratic":
            cost = QuadrotorQuadraticCost(x_coeff=50.0, v_coeff=5.0,
                                          terminal_cost_coeff=0.3, device=dev)
        else:
            rng = np.random.default_rng(1)
            data = (0.2 * np.abs(rng.normal(size=(64, 64)))).astype(np.float32)
            data[40:, 40:] = 3.0
            tex = MapTexture2D(data, origin=(-3.2, -3.2, 0.0), resolution=0.1, device=dev)
            cost = QuadrotorMapCost(costmap=tex, dist_to_waypoint_coeff=12.0,
                                    desired_speed=1.0, heading_power=1.5, device=dev
                                    ).update_waypoint(1.5, 0.0, 0.0, 1.5707964)
        return dyn, cost, x0, [0.5, 0.5, 0.5, 2.0], 9.81
    if pair.startswith("dubins"):
        goal = ([1.0, 2.0, 0.5] if pair == "dubins_quadratic" else
                np.random.default_rng(3).normal(size=(30, 3)).astype(np.float32))
        return (DubinsDynamics.create(device=dev),
                QuadraticCost(goal, [1.0, 2.0, 0.3], terminal_scale=2.0, current_time=3,
                              device=dev),
                torch.tensor([0.0, 0.0, 3.0], device=dev), [1.0, 1.0], 0.0)
    return (DoubleIntegratorDynamics.create(device=dev),
            QuadraticCost([-4.0, -4.0, 0.0, 0.0], [5.0, 5.0, 0.5, 0.5], output_dim=4,
                          device=dev),
            torch.tensor([-9.0, -9.0, 0.1, 0.1], device=dev), [0.5, 0.5], 0.0)


ZOO_PAIRS = ["cartpole", "quadrotor_quadratic", "quadrotor_map", "dubins_quadratic",
             "dubins_trajectory", "di_quadratic"]


def _zoo_samples(pair, K, dev):
    dyn, cost, x0, std, offset = _zoo_parts(pair, dev)
    Cz = dyn.CONTROL_DIM
    g = torch.Generator(device=dev).manual_seed(K)
    mean = 0.3 * torch.randn((T, Cz), generator=g, device=dev)
    mean[:, -1] += offset
    sigma = torch.tensor([std], device=dev).expand(T, Cz).contiguous()
    U = dyn.enforce_constraints(None, (mean + sigma * torch.randn(
        (K, T, Cz), generator=g, device=dev)).permute(2, 0, 1)).permute(1, 2, 0)
    lr = (mean, sigma, torch.full((Cz,), 0.5, device=dev), LAM, ALPHA, 0.9 * K)
    return dyn, cost, x0, U.contiguous(), lr, std, offset


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("pair", ZOO_PAIRS)
@pytest.mark.parametrize("mode", ["costs", "costs+lr", "epilogue+lr", "tsallis+lr"])
def test_zoo_rollout_kernel_matches_plain(cuda_device, K, pair, mode):
    dyn, cost, x0, U, lr, _, _ = _zoo_samples(pair, K, cuda_device)
    lr = lr if mode.endswith("+lr") else None
    fr.reset_launch_counts()
    if mode.startswith("costs"):
        kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lr, split_cost=False)
    elif mode.startswith("epilogue"):
        kc, kcrash, kout = fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lr,
                                                    split_cost=False)
    else:
        kc, kcrash, kout = fr.rollout_block_minima(dyn, cost, x0, U, DT, lr,
                                                   split_cost=False)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_staged_kernel"] == 1
    assert sum(fr.entry_counts.values()) == 1
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    if mode.startswith("epilogue"):
        _close(kout, fr.block_carries_plain(pc, U, LAM), rtol=1e-5, atol=1e-5)
    elif mode.startswith("tsallis"):
        assert torch.equal(kout, fr.block_minima_plain(pc))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("pair", ZOO_PAIRS)
@pytest.mark.parametrize("kind", ["gaussian", "nln"])
def test_zoo_fused_solve_kernel_matches_plain(cuda_device, K, pair, kind):
    dyn, cost, x0, _, _, std, offset = _zoo_samples(pair, K, cuda_device)
    Cz = dyn.CONTROL_DIM
    g = torch.Generator(device=cuda_device).manual_seed(K + 1)
    mean = 0.3 * torch.randn((T, Cz), generator=g, device=cuda_device)
    mean[:, -1] += offset
    cls = NLNDistribution if kind == "nln" else GaussianDistribution
    samp = cls.create(std_dev=std, control_cost_coeff=[0.5] * Cz,
                      pure_noise_percentage=P_PURE, device=cuda_device)
    seed = torch.tensor(K, dtype=torch.int32, device=cuda_device)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    fr.reset_launch_counts()
    kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, optimization_stride=2)
    torch.cuda.synchronize()
    assert fr.launch_counts["fused_solve_staged_kernel"] == 1
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, optimization_stride=2)
    _close(kU, pU, rtol=0, atol=0)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    _close(kcarry, pcarry, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("kind,epilogue", [("gaussian", False), ("nln", False),
                                           ("smooth", False), ("smooth", True)])
def test_cartpole_fused_sample_kernel_matches_plain(cuda_device, K, kind, epilogue):
    dyn, cost, x0, _, _ = _zoo_parts("cartpole", cuda_device)
    kw = dict(std_dev=[5.0], control_cost_coeff=[1.0], pure_noise_percentage=P_PURE,
              device=cuda_device)
    samp = {"nln": NLNDistribution, "gaussian": GaussianDistribution}.get(kind)
    samp = (samp.create(**kw) if samp is not None
            else SmoothMPPIDistribution.create(num_timesteps=T, dt=0.05, **kw))
    g = torch.Generator(device=cuda_device).manual_seed(K)
    mean = torch.randn((T, 1), generator=g, device=cuda_device)
    state = 0.3 * torch.ones((T, 1), device=cuda_device) if kind == "smooth" else None
    seed = torch.tensor(K + 7, dtype=torch.int32, device=cuda_device)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    fr.reset_launch_counts()
    kout = fr.fused_sample_rollout_costs(*args, optimization_stride=1, sampler_state=state,
                                         epilogue=epilogue)
    torch.cuda.synchronize()
    assert fr.entry_counts == {"fused_sample_rollout_cartpole": 1}
    pc, pcrash, pU, pW = fr.sample_rollout_plain(*args, optimization_stride=1,
                                                 sampler_state=state)
    _close(kout[0], pc, rtol=0, atol=0)
    assert torch.equal(kout[1], pcrash)
    _close(kout[2], pU, rtol=0, atol=0)
    if epilogue:
        pm, pb, pe = fr.flash_combine_plain(fr.block_carries_plain(pc, pW, LAM), T, 1, LAM)
        _close(kout[3], pm, rtol=1e-4, atol=1e-5)
        _close(kout[4], pb, rtol=1e-6, atol=0)
        _close(kout[5], pe, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_quadratic_entries_refuse_another_output_dim(cuda_device):
    dyn = DoubleIntegratorDynamics.create(device=cuda_device)
    cost = QuadraticCost([1.0, 2.0], device=cuda_device)  # O = 2: no entry reads it
    U = torch.zeros((64, T, C), device=cuda_device)
    with pytest.raises(NotImplementedError, match="OUTPUT_DIM"):
        fr.fused_rollout_costs(dyn, cost, torch.zeros(4, device=cuda_device), U, DT)
    # the zoo's per-sample-x0 entries (RMPPI's stage 1) launch and equal
    # their plain version
    cdyn, ccost, _, _, _ = _zoo_parts("cartpole", cuda_device)
    X0 = 0.1 * torch.randn((64, 4), generator=torch.Generator(device=cuda_device)
                           .manual_seed(6), device=cuda_device)
    U1 = torch.randn((64, T, 1), generator=torch.Generator(device=cuda_device)
                     .manual_seed(7), device=cuda_device)
    fr.reset_launch_counts()
    kc, kcrash = fr.fused_rollout_costs(cdyn, ccost, X0, U1, DT, split_cost=False)
    pc, pcrash = fr.rollout_costs_plain(cdyn, ccost, X0, U1, DT)
    torch.cuda.synchronize()
    assert fr.entry_counts == {"rollout_costs_x0_cartpole": 1}
    assert torch.equal(kc, pc) and torch.equal(kcrash, pcrash)


# --- the racer LSTM models: the recurrent LSTM step (B10) in B1 and B3 ---
RACER_INDICES = (2, 3, 5, 6, 0, 1)


def _racer_parts(kind, dev, seed=0):
    """The LSTM-steering model on a 64^2 elevation map with a 64^2 track map
    (0.15 |z|, a hot block ahead), or the LSTM-uncertainty model on flat
    ground without a costmap; LSTMs at scale 0.5 and a warm (h, c), so the
    networks move the samples apart."""
    rng = np.random.default_rng(seed)
    warm = {n: 0.3 * rng.normal(size=16)
            for n in RacerDubinsElevationLSTMUncertainty.WARM}
    nets = [LSTM.create(i, 16, [16 + i, 16, o], seed=seed + j, scale=0.5)
            for j, (i, o) in enumerate(((4, 1), (11, 2), (12, 5)))]
    x0 = torch.zeros(9 if kind == "steering" else 26, device=dev)
    x0[0], x0[1] = 3.0, 0.2
    if kind == "unc":
        dyn = RacerDubinsElevationLSTMUncertainty(*nets, warm=warm, device=dev)
        return dyn, ARStandardCost(output_indices=RACER_INDICES, device=dev), x0
    elev = MapTexture2D((0.3 * rng.normal(size=(64, 64))).astype("f"),
                        origin=(-8.0, -8.0, 0.0), resolution=0.25, device=dev)
    track = (0.15 * np.abs(rng.normal(size=(64, 64)))).astype("f")
    track[34:, 46:] = 3.0
    tex = MapTexture2D(track, origin=(-3.2, -3.2, 0.0), resolution=0.1, device=dev)
    dyn = RacerDubinsElevationLSTMSteering(nets[0], elev, warm_hidden=warm["warm_hidden"],
                                           warm_cell=warm["warm_cell"], device=dev)
    return dyn, ARStandardCost(costmap=tex, output_indices=RACER_INDICES, device=dev), x0


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("kind", ["steering", "unc"])
@pytest.mark.parametrize("mode", ["costs", "costs+lr", "epilogue+lr", "tsallis+lr"])
def test_racer_rollout_kernel_matches_plain(cuda_device, K, kind, mode):
    dyn, cost, x0 = _racer_parts(kind, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(K)
    mean = 0.3 * torch.randn((T, C), generator=g, device=cuda_device)
    sigma = torch.tensor([[0.3, 0.5]], device=cuda_device).expand(T, C).contiguous()
    U = (mean + sigma * torch.randn((K, T, C), generator=g, device=cuda_device)).clamp(-1, 1)
    lr = ((mean, sigma, torch.tensor([0.5, 1.0], device=cuda_device), LAM, ALPHA, 0.9 * K)
          if mode.endswith("+lr") else None)
    fr.reset_launch_counts()
    Uc = U.contiguous()
    if mode.startswith("costs"):
        kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, Uc, DT, lr, split_cost=False)
    elif mode.startswith("epilogue"):
        kc, kcrash, kout = fr.rollout_block_carries(dyn, cost, x0, Uc, DT, LAM, lr,
                                                    split_cost=False)
    else:
        kc, kcrash, kout = fr.rollout_block_minima(dyn, cost, x0, Uc, DT, lr,
                                                   split_cost=False)
    torch.cuda.synchronize()
    assert fr.entry_counts == {f"rollout_costs_racer_{kind}_ar": 1}
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U.contiguous(), DT, lr)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    if kind == "steering":
        assert 0 < int(pcrash.sum()) < K
    if mode.startswith("epilogue"):
        _close(kout, fr.block_carries_plain(pc, U, LAM), rtol=1e-5, atol=1e-5)
    elif mode.startswith("tsallis"):
        assert torch.equal(kout, fr.block_minima_plain(pc))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("kind", ["steering", "unc"])
@pytest.mark.parametrize("sampler", ["gaussian", "nln"])
def test_racer_fused_solve_kernel_matches_plain(cuda_device, K, kind, sampler):
    dyn, cost, x0 = _racer_parts(kind, cuda_device, seed=1)
    g = torch.Generator(device=cuda_device).manual_seed(K + 1)
    mean = 0.3 * torch.randn((T, C), generator=g, device=cuda_device)
    cls = NLNDistribution if sampler == "nln" else GaussianDistribution
    samp = cls.create(std_dev=[0.3, 0.5], control_cost_coeff=[0.5, 1.0],
                      pure_noise_percentage=P_PURE, device=cuda_device)
    seed = torch.tensor(K, dtype=torch.int32, device=cuda_device)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    fr.reset_launch_counts()
    kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, optimization_stride=2,
                                                             split_cost=False)
    torch.cuda.synchronize()
    assert fr.entry_counts == {f"fused_solve_racer_{kind}_ar": 1}
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, optimization_stride=2)
    _close(kU, pU, rtol=0, atol=0)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    _close(kcarry, pcarry, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_racer_kernels_refuse_what_they_are_not_built_for(cuda_device):
    dyn, cost, x0 = _racer_parts("unc", cuda_device)
    U = torch.zeros((64, T, C), device=cuda_device)
    flat_cost = ARStandardCost(device=cuda_device)  # AutoRally's output layout
    with pytest.raises(NotImplementedError, match="output"):
        fr.fused_rollout_costs(dyn, flat_cost, x0, U, DT)
    # the sampling kernel (B4) has a racer entry: it launches and counts
    samp = GaussianDistribution.create(std_dev=[0.3, 0.5], device=cuda_device)
    fr.reset_launch_counts()
    out = fr.fused_sample_rollout_costs(dyn, cost, samp, x0,
                                        torch.zeros((T, C), device=cuda_device),
                                        torch.tensor(1, dtype=torch.int32, device=cuda_device),
                                        DT, LAM, ALPHA, 64)
    torch.cuda.synchronize()
    assert fr.entry_counts == {"fused_sample_rollout_racer_unc_ar": 1}
    assert bool(torch.isfinite(out[0]).all())
    small = RacerDubinsElevationLSTMSteering(LSTM.create(4, 8, [12, 8, 1], seed=0),
                                             device=cuda_device)
    with pytest.raises(NotImplementedError, match="steering LSTM"):
        fr.fused_rollout_costs(small, cost, x0[:9].contiguous(), U, DT)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["steering", "unc"])
@pytest.mark.parametrize("kernel", ["fused", "fused_solve"])
def test_racer_vanilla_kernels_match_combined_on_the_card(cuda_device, kind, kernel):
    """The eager LSTMs and head sum with matmuls, the kernels left to right:
    the costs sit an ulp or so apart; the mean's tolerance follows from them."""
    def build(k):
        dyn, cost, _ = _racer_parts(kind, "cpu", seed=2)
        return VanillaMPPI(dyn, cost, GaussianDistribution.create(std_dev=[0.3, 0.5]),
                           num_timesteps=T, num_rollouts=300, kernel=k, return_samples=True)

    ctrl, combined = build(kernel), build("combined")
    x0 = _racer_parts(kind, cuda_device)[2]
    eps = torch.randn((300, T, C), device=cuda_device)
    state = ctrl.init_state(seed=0)
    rf, _ = ctrl.solve(x0, state, injected_noise=eps)
    rc, _ = combined.solve(x0, state, injected_noise=eps)
    _close(rf.costs, rc.costs, rtol=1e-4, atol=1e-3)
    assert torch.equal(rf.crash, rc.crash)
    tol = mean_tolerance(rf, rc, rc.sampled_controls, LAM_AR)
    _close(rf.control_mean, rc.control_mean, rtol=0, atol=tol)
    assert bool(torch.isfinite(rf.state_trajectory).all())


# --- the robust family: B6 (4, 1), (7, 2); B7 and B8 with staged models ------
def _partial_map(dev):
    """A 32^2 map (0.1 m texels) of 0.15 |z| with a hot block ahead and to
    the left of the car: part of the AutoRally samples crash."""
    m = (0.15 * np.abs(np.random.default_rng(11).normal(size=(32, 32)))).astype("f")
    m[21:, 27:] = 3.0
    return MapTexture2D(m, origin=(-1.6, -1.6, 0.0), resolution=0.1, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("S_,C_", [(4, 1), (7, 2)])
def test_riccati_backward_new_sizes_match_plain(cuda_device, S_, C_):
    rng = np.random.default_rng(S_ + C_)
    T_ = 150
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    As = f(np.eye(S_) + 0.05 * rng.normal(size=(T_, S_, S_)))
    Bs = f(0.1 * rng.normal(size=(T_, S_, C_)))
    dLx, dLu = f(rng.normal(size=(T_, S_))), f(rng.normal(size=(T_, C_)))
    Q, R = f(np.eye(S_)), f(0.5 * np.eye(C_))
    Vxx_T, Vx_T = f(2 * np.eye(S_)), f(rng.normal(size=S_))
    riccati.reset_launch_counts()
    kK, kk = riccati.riccati_backward(As, Bs, dLx, dLu, Q, R, Vxx_T, Vx_T, DT)
    torch.cuda.synchronize()
    assert riccati.launch_counts["riccati_backward_warp_kernel"] == 1
    pK, pk = riccati.riccati_backward_plain(As, Bs, dLx, dLu, Q * DT, R * DT, Vxx_T,
                                            Vx_T, DT, 1e-6)
    _close(kK, pK, rtol=1e-5, atol=1e-6)
    _close(kk, pk, rtol=1e-5, atol=1e-6)


def _model_ladder_problem(kind, dev, T_):
    """The first iLQR iteration's ladder inputs for AutoRally (random
    network, numpy seed 0, scale 1) or the cartpole."""
    g = torch.Generator(device=dev).manual_seed(T_)
    if kind == "autorally":
        dyn = AutorallyNNDynamics(FNN.create([6, 32, 32, 4], seed=0, scale=1.0),
                                  control_ranges=[[-0.9, 0.9], [-0.6, 1.0]], device=dev)
        x0 = _ar_x0(dev)
    else:
        dyn = CartpoleDynamics.create(control_ranges=[[-5.0, 5.0]], device=dev)
        x0 = torch.tensor([0.1, -0.2, 0.6, 0.3], device=dev)
    S_, C_ = dyn.STATE_DIM, dyn.CONTROL_DIM
    lo, hi = dyn.control_ranges[:, 0].contiguous(), dyn.control_ranges[:, 1].contiguous()
    us = torch.clamp(0.4 * torch.randn((T_, C_), generator=g, device=dev), lo, hi)
    xs = [x0]
    for t in range(T_ - 1):
        xs.append(xs[-1] + dyn.state_deriv(xs[-1], us[t]) * DT)
    xs = torch.stack(xs)
    goal_x = xs + 0.05 * torch.randn((T_, S_), generator=g, device=dev)
    goal_u = torch.zeros((T_, C_), device=dev)
    Q, R = torch.eye(S_, device=dev), 0.5 * torch.eye(C_, device=dev)
    Qf = 3 * Q
    lin = linearize(dyn, xs, us, goal_x, goal_u, Q, R, Qf, DT)
    return dyn, (xs, us, *lin[:4], Q, R, Qf, lin[4], lin[5], goal_x, goal_u,
                 _alpha_ladder(device=dev), lo, hi, DT)


@pytest.mark.cuda
@pytest.mark.parametrize("T_", [24, 150])
@pytest.mark.parametrize("kind", ["cartpole", "autorally"])
def test_riccati_ladder_with_the_model_matches_plain(cuda_device, kind, T_):
    dyn, args = _model_ladder_problem(kind, cuda_device, T_)
    riccati.reset_launch_counts()
    kout = riccati.riccati_ladder_solve(dyn, *args)
    torch.cuda.synchronize()
    assert riccati.launch_counts["riccati_ladder_warp_kernel"] == 1
    xs, us, As, Bs, dLx, dLu, Q, R, Qf, Vxx_T, Vx_T, goal_x, goal_u, alphas, lo, hi, _ = args
    pK, pk = riccati.riccati_backward_plain(As, Bs, dLx, dLu, Q * DT, R * DT, Vxx_T,
                                            Vx_T, DT, 1e-6)
    pout = (pK, pk) + riccati.ladder_forward_plain(
        dyn, xs, us, pK, pk, goal_x, goal_u, Q, R, Qf, alphas, torch.stack([lo, hi]), DT)
    for got, want in zip(kout, pout):
        _close(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("robust", [False, True])
def test_rmppi_rollout_kernel_autorally_matches_plain(cuda_device, K, robust):
    dev = cuda_device
    dyn = AutorallyNNDynamics(FNN.create([6, 32, 32, 4], seed=0, scale=1.0),
                              control_ranges=[[-0.9, 0.9], [-0.6, 1.0]], device=dev)
    cost = (ARRobustCost if robust else ARStandardCost)(costmap=_partial_map(dev),
                                                        device=dev)
    g = torch.Generator(device=dev).manual_seed(K + robust)
    U = 0.5 * torch.randn((K, T, C), generator=g, device=dev)
    gains = -0.5 * torch.rand((T, C, 7), generator=g, device=dev)
    sigma = torch.tensor([[0.3, 0.5]], device=dev).expand(T, C).contiguous()
    x_nom = _ar_x0(dev)
    x_real = x_nom + torch.tensor([0.05, -0.04, 0.03, 0.0, 0.2, 0.05, 0.02], device=dev)
    args = (dyn, cost, x_nom, x_real, U, gains, sigma, torch.tensor([0.5, 1.0], device=dev),
            DT, LAM, ALPHA)
    fr.reset_launch_counts()
    kout = fr.fused_rmppi_rollout(*args)
    torch.cuda.synchronize()
    assert fr.entry_counts == {"rmppi_rollout_ar_nn": 1}
    pout = fr.rmppi_rollout_plain(*args)
    for k, p in zip(kout[:3], pout[:3]):
        _close(k, p, rtol=1e-5, atol=1e-6)
    assert torch.equal(kout[3], pout[3])
    assert 0 < int(kout[3].sum()) < K  # part of the samples crash
    _close(kout[4], pout[4], rtol=0, atol=0)


def _di_robust(dev):
    dyn = DoubleIntegratorDynamics.create(control_ranges=[[-2.5, 2.5], [-2.0, 2.0]],
                                          control_deadband=[0.05, 0.1], device=dev)
    return dyn, DoubleIntegratorRobustCost(discount=0.95, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 250])
def test_rmppi_rollout_kernel_di_robust_matches_plain(cuda_device, K):
    dev = cuda_device
    dyn, cost = _di_robust(dev)
    g = torch.Generator(device=dev).manual_seed(K)
    U = 1.2 * torch.randn((K, T, C), generator=g, device=dev)
    gains = -0.8 * torch.rand((T, C, 4), generator=g, device=dev)
    sigma = 0.6 + 0.8 * torch.rand((T, C), generator=g, device=dev)
    args = (dyn, cost, torch.tensor([2.05, 0.0, 0.0, 1.9], device=dev),
            torch.tensor([2.12, -0.05, 0.1, 1.8], device=dev), U, gains, sigma,
            torch.tensor([0.02, 0.5], device=dev), DT, LAM, ALPHA)
    fr.reset_launch_counts()
    kout = fr.fused_rmppi_rollout(*args)
    torch.cuda.synchronize()
    assert fr.entry_counts == {"rmppi_rollout_di_robust": 1}
    pout = fr.rmppi_rollout_plain(*args)
    for k, p in zip(kout[:3], pout[:3]):
        _close(k, p, rtol=1e-5, atol=1e-6)
    assert torch.equal(kout[3], pout[3])
    _close(kout[4], pout[4], rtol=0, atol=0)
    assert float(kout[0].max()) > float(cost.crash_cost) / T  # off the track too


@pytest.mark.cuda
def test_rollout_kernel_per_sample_x0_di_robust_matches_plain(cuda_device):
    dev = cuda_device
    dyn, cost = _di_robust(dev)
    K = 9 * 16
    g = torch.Generator(device=dev).manual_seed(9)
    w = torch.linspace(0.0, 1.0, 9, device=dev)[:, None]
    a = torch.tensor([1.9, 0.0, 0.0, 2.0], device=dev)
    b = torch.tensor([2.3, 0.2, 0.3, 1.6], device=dev)
    x0s = ((1 - w) * a + w * b).repeat_interleave(16, dim=0).contiguous()
    U = torch.randn((K, T, C), generator=g, device=dev)
    fr.reset_launch_counts()
    kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0s, U, DT, split_cost=False)
    torch.cuda.synchronize()
    assert fr.entry_counts == {"rollout_costs_x0_di_robust": 1}
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0s, U, DT)
    _close(kc, pc, rtol=1e-5, atol=1e-6)
    assert torch.equal(kcrash, pcrash)


@pytest.mark.cuda
def test_robust_autorally_kernels_match_combined_on_the_card(cuda_device):
    """One RMPPI cycle and one Tube fused solve on AutoRally (K=256, T=24,
    9 x 16) through the kernels, against kernel="combined" on the same
    normals. The eager network sums with a matmul: costs rtol 1e-4 / atol
    1e-3; the means within 2 max|dJ| / lambda times the samples' spread."""
    dev = cuda_device
    dyn = AutorallyNNDynamics(FNN.create([6, 32, 32, 4], seed=0, scale=1.0),
                              control_ranges=[[-0.9, 0.9], [-0.6, 1.0]], device=dev)
    x = _ar_x0(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    e1 = torch.randn((16, T, C), generator=g, device=dev)
    e2 = torch.randn((256, T, C), generator=g, device=dev)
    kw = dict(feedback=DDPFeedback.create(dyn, DT), dt=DT, num_timesteps=T,
              num_rollouts=256, device=dev)
    outs, warm = {}, None
    for kernel in ("combined", "fused"):
        ctrl = RobustMPPI(dyn, ARRobustCost(costmap=_partial_map(dev), device=dev),
                          GaussianDistribution.create(std_dev=[0.3, 0.5], device=dev),
                          num_candidates=9, samples_per_condition=16, kernel=kernel, **kw)
        if warm is None:  # one warm state, with a nominal system, for both
            warm, _ = ctrl.update_importance_sampling(x, ctrl.init_state(seed=0), 1)
            _, warm = ctrl.solve(x, warm)
        cs, fe = ctrl.update_importance_sampling(x, warm, 1, injected_noise=e1)
        res, _ = ctrl.solve(x, cs, injected_noise=e2)
        outs[kernel] = (fe, res, cs)
    for kernel in ("fused_solve", "combined"):
        ctrl = TubeMPPI(dyn, ARStandardCost(costmap=_partial_map(dev), device=dev),
                        GaussianDistribution.create(std_dev=[0.3, 0.5], device=dev),
                        kernel=kernel, **kw)
        res, _ = ctrl.solve(x, ctrl.init_state(seed=0), injected_noise=e2)
        outs[f"tube {kernel}"] = (None, res, None)
    for a, b in (("fused", "combined"), ("tube fused_solve", "tube combined")):
        ra, rb = outs[a][1], outs[b][1]
        for system in ("real", "nominal"):
            sa, sb = getattr(ra, system), getattr(rb, system)
            _close(sa.costs, sb.costs, rtol=1e-4, atol=1e-3)
            assert torch.equal(sa.crash, sb.crash)
            dJ = float((sa.costs - sb.costs).abs().max())
            # |U - mean| <= 1.8 within the control ranges
            _close(sa.control_mean, sb.control_mean, rtol=0,
                   atol=2 * dJ / LAM_AR * 1.8 + 1e-5)
    _close(outs["fused"][0], outs["combined"][0], rtol=1e-4, atol=1e-3)


# --- the split form (csrc/split_kernels.cuh): B1 and B3, DI and AutoRally ---
def _split_parts(pair, dev):
    """(dynamics, cost, x0, control std) of a pair with split entries. For
    AutoRally, the network at scale 0.5 (its samples spread by about 0.1 m
    over 24 steps) and a boundary stripe at world x >= 1.8 m (0.1 m texels),
    which part of the samples reach at different steps, so the prefix OR of
    the triggers decides the costs."""
    if pair == "di_circle":
        return (DoubleIntegratorDynamics.create(device=dev), DoubleIntegratorCircleCost(device=dev),
                torch.tensor([2.0, 0.05, -0.1, 1.0], device=dev), [0.8, 1.3])
    dyn = AutorallyNNDynamics(FNN.create([6, 32, 32, 4], seed=0, scale=0.5), device=dev)
    data = np.zeros((64, 64), np.float32)
    data[:, 50:] = 1.0
    tex = MapTexture2D(data, origin=(-3.2, -3.2, 0.0), resolution=0.1, device=dev)
    return dyn, ARStandardCost(costmap=tex, device=dev), _ar_x0(dev), [0.3, 0.5]


def _cost_pass(pair, cost, dev, K_, T_):
    """The counted name of the split cost pass that ``pair``'s entry
    launches for K_ samples over T_ steps of ``cost`` on ``dev``."""
    return fr.split_cost_kernel_name(_build.pair_entry(pair, "split_cost"), dev.index, K_, T_,
                                     cost.time_parallel_crash())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("pair", ["di_circle", "ar_nn"])
@pytest.mark.parametrize("mode", ["costs", "costs+lr", "epilogue+lr", "tsallis+lr"])
def test_split_rollout_kernels_match_plain(cuda_device, K, pair, mode):
    """B1's split form against its plain version: costs, crash flags and
    block minima bit for bit, carries within rtol 1e-5; two launches."""
    dyn, cost, x0, std = _split_parts(pair, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(K + 5)
    mean = 0.2 * torch.randn((T, C), generator=g, device=cuda_device)
    sigma = torch.tensor([std], device=cuda_device).expand(T, C).contiguous()
    U = (mean + sigma * torch.randn((K, T, C), generator=g, device=cuda_device)).contiguous()
    lr = ((mean, sigma, torch.tensor([0.5, 1.0], device=cuda_device), LAM, ALPHA,
           0.9 * K) if mode.endswith("+lr") else None)
    fr.reset_launch_counts()
    if mode.startswith("costs"):
        kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lr, split_cost=True)
    elif mode.startswith("epilogue"):
        kc, kcrash, kout = fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lr,
                                                    split_cost=True)
    else:
        kc, kcrash, kout = fr.rollout_block_minima(dyn, cost, x0, U, DT, lr,
                                                   split_cost=True)
    torch.cuda.synchronize()
    # AutoRally's pass is the warp form (csrc/split_warp.cuh), the DI's the
    # staged form (csrc/split_staged.cuh)
    assert fr.launch_counts["split_dynamics_warp_kernel" if pair == "ar_nn"
                            else "split_dynamics_staged_kernel"] == 1
    assert fr.launch_counts[_cost_pass(pair, cost, cuda_device, K, T)] == 1
    assert fr.launch_counts["rollout_costs_warp_kernel" if pair == "ar_nn"
                            else "rollout_costs_staged_kernel"] == 0
    pc, pcrash = fr.split_rollout_plain(dyn, cost, x0, U, DT, lr)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    if pair == "ar_nn":
        assert 0 < int(pcrash.sum()) < K  # a mixed crash population
    if mode.startswith("epilogue"):
        _close(kout, fr.block_carries_plain(pc, U, LAM), rtol=1e-5, atol=1e-5)
    elif mode.startswith("tsallis"):
        assert torch.equal(kout, fr.block_minima_plain(pc))
    # the combined kernel on the same inputs: the same crash flags, costs
    # summed in another order
    cc, ccrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lr, split_cost=False)
    assert torch.equal(ccrash, kcrash)
    _close(kc, cc, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("pair", ["di_circle", "ar_nn"])
@pytest.mark.parametrize("kind", ["gaussian", "nln"])
@pytest.mark.parametrize("inject", [False, True])
def test_split_solve_kernels_match_plain(cuda_device, K, pair, kind, inject):
    """B3's split form against its plain version: U, costs and crash flags
    bit for bit, carries within rtol 1e-5; two launches."""
    dyn, cost, x0, std = _split_parts(pair, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(K + 3)
    kw = dict(std_dev=std, pure_noise_percentage=P_PURE, device=cuda_device)
    samp = NLNDistribution.create(**kw) if kind == "nln" else GaussianDistribution.create(**kw)
    mean = 0.2 * torch.randn((T, C), generator=g, device=cuda_device)
    seed = torch.randint(0, 2**31 - 1, (), generator=g, dtype=torch.int32,
                         device=cuda_device)
    z = (torch.randn((2 if kind == "nln" else 1, K, T, C), generator=g, device=cuda_device)
         if inject else None)
    z = z[0] if inject and kind == "gaussian" else z
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    kw = dict(iteration=0, optimization_stride=2, injected_noise=z)
    fr.reset_launch_counts()
    kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, split_cost=True, **kw)
    torch.cuda.synchronize()
    assert fr.launch_counts["split_solve_dynamics_warp_kernel" if pair == "ar_nn"
                            else "split_solve_dynamics_staged_kernel"] == 1
    assert fr.launch_counts[_cost_pass(pair, cost, cuda_device, K, T)] == 1
    assert fr.launch_counts["fused_solve_warp_kernel" if pair == "ar_nn"
                            else "fused_solve_staged_kernel"] == 0
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_split_plain(*args, **kw)
    _close(kU, pU, rtol=0, atol=0)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    _close(kcarry, pcarry, rtol=1e-5, atol=1e-5)
    cc, ccrash, cU, _ = fused_solve.fused_solve_carries(*args, split_cost=False, **kw)
    assert torch.equal(cU, kU) and torch.equal(ccrash, kcrash)
    _close(kc, cc, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_split_cost_true_raises_without_an_entry(cuda_device):
    """split_cost=True on the card: the cartpole (an eligible cost with
    split entries) and one x0 per sample for the DI robust cost and the DI
    circle cost (RMPPI's candidates, the bench row's stage 1) launch the
    split kernels; an ineligible cost raises KernelIncompatible (a
    ValueError) on every device."""
    x0c = torch.zeros(4, device=cuda_device)
    U1 = torch.zeros((64, T, 1), device=cuda_device)
    cart, ccost = CartpoleDynamics.create(device=cuda_device), CartpoleQuadraticCost(device=cuda_device)
    assert ccost.time_parallel_cost()
    fr.reset_launch_counts()
    kc, _ = fr.fused_rollout_costs(cart, ccost, x0c, U1, DT, split_cost=True)
    samp = GaussianDistribution.create(std_dev=[1.0], device=cuda_device)
    fused_solve.fused_solve_iteration(cart, ccost, samp, x0c,
                                      torch.zeros((T, 1), device=cuda_device), 0,
                                      DT, LAM, ALPHA, 64, split_cost=True)
    torch.cuda.synchronize()
    assert fr.entry_counts == {"split_dynamics_cartpole": 1, "split_solve_dynamics_cartpole": 1,
                               "split_cost_cartpole": 2}
    _close(kc, fr.split_rollout_plain(cart, ccost, x0c, U1, DT)[0], rtol=0, atol=0)
    rdyn, rcost = _di_robust(cuda_device)
    X0 = torch.tensor([2.0, 0.0, 0.0, 2.0], device=cuda_device).expand(64, 4).contiguous()
    U = torch.zeros((64, T, C), device=cuda_device)
    fr.reset_launch_counts()
    kc, _ = fr.fused_rollout_costs(rdyn, rcost, X0, U, DT, split_cost=True)
    torch.cuda.synchronize()
    assert fr.entry_counts == {"split_dynamics_x0_di_robust": 1, "split_cost_di_robust": 1}
    _close(kc, fr.split_rollout_plain(rdyn, rcost, X0, U, DT)[0], rtol=0, atol=0)
    dyn, cost, x0, _ = _split_parts("di_circle", cuda_device)
    X0 = x0.expand(64, 4).contiguous()
    fr.reset_launch_counts()
    kc, _ = fr.fused_rollout_costs(dyn, cost, X0, U, DT, split_cost=True)
    torch.cuda.synchronize()
    assert fr.entry_counts == {"split_dynamics_x0_di_circle": 1, "split_cost_di_circle": 1}
    _close(kc, fr.split_rollout_plain(dyn, cost, X0, U, DT)[0], rtol=0, atol=0)
    qcost = QuadrotorMapCost(device=cuda_device)
    assert not qcost.time_parallel_cost() and not qcost.time_parallel_crash()
    quad = QuadrotorDynamics.create(device=cuda_device)
    with pytest.raises(ValueError, match="time_parallel"):
        fr.fused_rollout_costs(quad, qcost, torch.zeros(13, device=cuda_device),
                               torch.zeros((64, T, 4), device=cuda_device), DT,
                               split_cost=True)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "fused_solve"])
def test_split_vanilla_solve_launches_the_split_kernels(cuda_device, kernel):
    """A forced-split DI solve on the card launches the dynamics pass, the
    cost pass and the merge, and agrees with the eager kernel="split"."""
    def build(k, split):
        return VanillaMPPI(DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
                           GaussianDistribution.create(std_dev=[1.0, 1.0]),
                           num_timesteps=T, num_rollouts=300, kernel=k, split_cost=split,
                           return_samples=True)

    ctrl, eager = build(kernel, True), build("split", None)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0], device=cuda_device)
    z = torch.randn((300, T, C), device=cuda_device)
    fr.reset_launch_counts()
    rf, _ = ctrl.solve(x, ctrl.init_state(0), injected_noise=z)
    torch.cuda.synchronize()
    dyn_kernel = ("split_solve_dynamics_staged_kernel" if kernel == "fused_solve"
                  else "split_dynamics_staged_kernel")
    assert {k: v for k, v in fr.launch_counts.items() if v} == {
        dyn_kernel: 1, _cost_pass("di_circle", ctrl.cost, cuda_device, 300, T): 1,
        "flash_combine_tiled_kernel": 1}
    re, _ = eager.solve(x, eager.init_state(0), injected_noise=z)
    _close(rf.costs, re.costs, rtol=1e-5, atol=1e-4)
    assert torch.equal(rf.crash, re.crash)
    tol = mean_tolerance(rf, re, re.sampled_controls, LAM_AR)
    _close(rf.control_mean, re.control_mean, rtol=0, atol=tol)


# --- every pair on every kernel mode: B4 for every pair, the bicycle's B3,
# the split form of the eligible pairs, the per-sample-x0 split ---
def _pair_parts(pair, dev):
    """(dynamics, cost, x0, control std, mean offset of the last channel) of
    any pair of ``fr._PAIRS`` at a test size; the maps let part of the
    samples crash."""
    if pair in ("cartpole", "quadrotor_quadratic", "quadrotor_map", "dubins_quadratic",
                "di_quadratic"):
        return _zoo_parts(pair, dev)
    if pair in ("racer_steering_ar", "racer_unc_ar"):
        return (*_racer_parts(pair.split("_")[1], dev), [0.3, 0.5], 0.0)
    if pair == "bicycle_ar":
        x0 = torch.zeros(10, device=dev)
        x0[5] = 2.0
        return (*_bicycle_parts(dev), x0, [0.3, 0.5], 0.0)
    if pair == "di_robust":
        return (*_di_robust(dev), torch.tensor([2.0, 0.0, 0.0, 2.0], device=dev),
                [1.0, 1.0], 0.0)
    return (*_split_parts(pair, dev), 0.0)


SAMPLE_PAIRS = ["ar_nn", "bicycle_ar", "quadrotor_quadratic", "quadrotor_map",
                "dubins_quadratic", "di_quadratic", "di_robust", "racer_steering_ar",
                "racer_unc_ar"]


def _pair_sampler(kind, std, dev, T_=T):
    kw = dict(std_dev=std, control_cost_coeff=[1.0] * len(std),
              pure_noise_percentage=P_PURE, device=dev)
    if kind == "smooth":
        return SmoothMPPIDistribution.create(num_timesteps=T_, dt=0.05, **kw)
    return (NLNDistribution if kind == "nln" else GaussianDistribution).create(**kw)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("pair", SAMPLE_PAIRS)
@pytest.mark.parametrize("kind,epilogue", [("gaussian", False), ("nln", False),
                                           ("smooth", False), ("smooth", True)])
def test_pair_fused_sample_kernel_matches_plain(cuda_device, K, pair, kind, epilogue):
    """B4 of every pair that gained it against its plain version: costs,
    crash flags, U and W bit for bit, the merged derivative mean within
    rtol 1e-4; one launch, counted under the pair's entry."""
    dyn, cost, x0, std, offset = _pair_parts(pair, cuda_device)
    Cp = dyn.CONTROL_DIM
    samp = _pair_sampler(kind, std, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(K + 11)
    mean = 0.3 * torch.randn((T, Cp), generator=g, device=cuda_device)
    mean[:, -1] += offset
    state = 0.3 * torch.randn((T, Cp), generator=g, device=cuda_device) if kind == "smooth" else None
    seed = torch.tensor(K + 5, dtype=torch.int32, device=cuda_device)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    fr.reset_launch_counts()
    kout = fr.fused_sample_rollout_costs(*args, optimization_stride=2, sampler_state=state,
                                         epilogue=epilogue)
    torch.cuda.synchronize()
    assert fr.entry_counts == {f"fused_sample_rollout_{pair}": 1}
    pc, pcrash, pU, pW = fr.sample_rollout_plain(*args, optimization_stride=2,
                                                 sampler_state=state)
    _close(kout[0], pc, rtol=0, atol=0)
    assert torch.equal(kout[1], pcrash)
    _close(kout[2], pU, rtol=0, atol=0)
    if epilogue:
        pm, pb, pe = fr.flash_combine_plain(fr.block_carries_plain(pc, pW, LAM), T, Cp, LAM)
        _close(kout[3], pm, rtol=1e-4, atol=1e-5)
        _close(kout[4], pb, rtol=1e-6, atol=0)
        _close(kout[5], pe, rtol=1e-5, atol=0)
    elif kind == "smooth":
        _close(kout[3], pW, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("pair", ["bicycle_ar", "di_robust"])
@pytest.mark.parametrize("kind", ["gaussian", "nln"])
def test_pair_fused_solve_kernel_matches_plain(cuda_device, K, pair, kind):
    """The new B3 entries against their plain version: U and costs bit for
    bit, carries within rtol 1e-5."""
    dyn, cost, x0, std, _ = _pair_parts(pair, cuda_device)
    samp = _pair_sampler(kind, std, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(K + 13)
    mean = 0.3 * torch.randn((T, C), generator=g, device=cuda_device)
    seed = torch.tensor(K + 3, dtype=torch.int32, device=cuda_device)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    fr.reset_launch_counts()
    kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, optimization_stride=2,
                                                             split_cost=False)
    torch.cuda.synchronize()
    assert fr.entry_counts == {f"fused_solve_{pair}": 1}
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, optimization_stride=2)
    _close(kU, pU, rtol=0, atol=0)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    _close(kcarry, pcarry, rtol=1e-5, atol=1e-5)


SPLIT_PAIRS = ["cartpole", "quadrotor_quadratic", "di_quadratic", "dubins_quadratic",
               "bicycle_ar", "racer_steering_ar", "racer_unc_ar"]


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("pair", SPLIT_PAIRS)
@pytest.mark.parametrize("mode", ["costs", "costs+lr", "epilogue+lr", "tsallis+lr"])
def test_split_pair_rollout_kernels_match_plain(cuda_device, K, pair, mode):
    """B1's split form of every pair that gained it against its plain
    version: costs, crash flags and block minima bit for bit, carries within
    rtol 1e-5; the dynamics pass and the cost pass, one launch each."""
    dyn, cost, x0, std, offset = _pair_parts(pair, cuda_device)
    Cp = dyn.CONTROL_DIM
    g = torch.Generator(device=cuda_device).manual_seed(K + 17)
    mean = 0.2 * torch.randn((T, Cp), generator=g, device=cuda_device)
    mean[:, -1] += offset
    sigma = torch.tensor([std], device=cuda_device).expand(T, Cp).contiguous()
    U = dyn.enforce_constraints(None, (mean + sigma * torch.randn(
        (K, T, Cp), generator=g, device=cuda_device)).permute(2, 0, 1)).permute(1, 2, 0)
    U = U.contiguous()
    lr = ((mean, sigma, torch.full((Cp,), 0.5, device=cuda_device), LAM, ALPHA, 0.9 * K)
          if mode.endswith("+lr") else None)
    epi = {"costs": fr.EPI_NONE, "costs+lr": fr.EPI_NONE, "epilogue+lr": fr.EPI_EXP,
           "tsallis+lr": fr.EPI_MIN}[mode]
    fr.reset_launch_counts()
    kc, kcrash, kout = fr._rollout_any(dyn, cost, x0, U, DT, lr, epi, LAM, True)
    torch.cuda.synchronize()
    assert fr.entry_counts == {f"split_dynamics_{pair}": 1, f"split_cost_{pair}": 1}
    pc, pcrash = fr.split_rollout_plain(dyn, cost, x0, U, DT, lr)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    if epi == fr.EPI_EXP:
        _close(kout, fr.block_carries_plain(pc, U, LAM), rtol=1e-5, atol=1e-5)
    elif epi == fr.EPI_MIN:
        assert torch.equal(kout, fr.block_minima_plain(pc))
    cc, ccrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lr, split_cost=False)
    assert torch.equal(ccrash, kcrash)
    _close(kc, cc, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("pair", SPLIT_PAIRS)
@pytest.mark.parametrize("kind", ["gaussian", "nln"])
def test_split_pair_solve_kernels_match_plain(cuda_device, K, pair, kind):
    """B3's split form of every pair that gained it against its plain
    version: U, costs and crash flags bit for bit, carries within rtol
    1e-5."""
    dyn, cost, x0, std, offset = _pair_parts(pair, cuda_device)
    Cp = dyn.CONTROL_DIM
    samp = _pair_sampler(kind, std, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(K + 19)
    mean = 0.2 * torch.randn((T, Cp), generator=g, device=cuda_device)
    mean[:, -1] += offset
    seed = torch.tensor(K + 9, dtype=torch.int32, device=cuda_device)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    fr.reset_launch_counts()
    kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, optimization_stride=2,
                                                             split_cost=True)
    torch.cuda.synchronize()
    assert fr.entry_counts == {f"split_solve_dynamics_{pair}": 1, f"split_cost_{pair}": 1}
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_split_plain(*args, optimization_stride=2)
    _close(kU, pU, rtol=0, atol=0)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    _close(kcarry, pcarry, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["di_robust", "ar_nn"])
def test_split_x0_kernels_match_plain(cuda_device, pair):
    """B1's split form from one x0 per sample (RMPPI's 9 candidates x 32
    samples) against its plain version and the combined per-sample-x0
    kernel: costs and crash flags bit for bit against the plain version."""
    dyn, cost, x0, std, _ = _pair_parts(pair, cuda_device)
    dx = (torch.tensor([0.4, 0.2, 0.3, -0.4], device=cuda_device) if pair == "di_robust"
          else torch.tensor([0.5, 0.3, 0.1, 0.0, -0.5, 0.0, 0.0], device=cuda_device))
    w = torch.linspace(0.0, 1.0, 9, device=cuda_device)[:, None]
    X0 = (x0[None] + w * dx[None]).repeat_interleave(32, dim=0).contiguous()
    K = X0.shape[0]
    g = torch.Generator(device=cuda_device).manual_seed(23)
    sigma = torch.tensor([std], device=cuda_device).expand(T, C)
    U = (sigma * torch.randn((K, T, C), generator=g, device=cuda_device)).contiguous()
    fr.reset_launch_counts()
    kc, kcrash = fr.fused_rollout_costs(dyn, cost, X0, U, DT, split_cost=True)
    torch.cuda.synchronize()
    assert fr.entry_counts == {f"split_dynamics_x0_{pair}": 1, f"split_cost_{pair}": 1}
    pc, pcrash = fr.split_rollout_plain(dyn, cost, X0, U, DT)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    cc, ccrash = fr.fused_rollout_costs(dyn, cost, X0, U, DT, split_cost=False)
    assert torch.equal(ccrash, kcrash)
    _close(kc, cc, rtol=1e-5, atol=1e-4)


# --- the warp form of the split dynamics passes (csrc/split_warp.cuh): the
# network pairs at the paths' shapes ---
WARP_PAIRS = ["ar_nn", "racer_steering_ar", "racer_unc_ar"]
WARP_T = 150
# (K, pure-noise share, stride): the full shape, the ragged one (a 10 %
# pure-noise tail, stride 2; the racers' last block of 8 samples has 4) and
# one whose last block has a single sample of AutoRally's 4 (5 of 8)
WARP_SHAPES = {"full": (1920, 0.0, 0), "ragged": (1900, 0.1, 2),
               "partial_block": (1901, 0.1, 2)}


def _warp_inputs(pair, dev, K, p, stride, seed):
    """(dynamics, cost, x0, U (K, T, C) clamped, mean, the Gaussian sampler)
    of a warp pair on its partly-crashing map (``_pair_parts``)."""
    dyn, cost, x0, std, offset = _pair_parts(pair, dev)
    Cp = dyn.CONTROL_DIM
    g = torch.Generator(device=dev).manual_seed(seed)
    mean = 0.2 * torch.randn((WARP_T, Cp), generator=g, device=dev)
    mean[:, -1] += offset
    samp = GaussianDistribution.create(std_dev=std, pure_noise_percentage=p, device=dev)
    U, _ = samp.sample(g, mean, K, optimization_stride=stride)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    return dyn, cost, x0, U, mean, samp


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(WARP_SHAPES))
@pytest.mark.parametrize("pair", WARP_PAIRS)
def test_split_warp_dynamics_pass_matches_plain(cuda_device, pair, shape):
    """B1's split dynamics pass in its warp form against its plain version:
    Y (T, O, K) bit for bit, and the whole split form's costs, crash flags
    and block minima; one launch of split_dynamics_warp_kernel."""
    K, p, stride = WARP_SHAPES[shape]
    dyn, cost, x0, U, mean, samp = _warp_inputs(pair, cuda_device, K, p, stride, 31)
    fr.reset_launch_counts()
    Y = fr.split_dynamics_cuda(dyn, cost, x0, U, DT)
    torch.cuda.synchronize()
    assert fr.launch_counts["split_dynamics_warp_kernel"] == 1
    assert fr.launch_counts["split_dynamics_kernel"] == 0
    pY = fr.split_outputs_plain(dyn, x0, U, DT).permute(1, 2, 0)
    assert torch.isfinite(pY).all()
    _close(Y, pY, rtol=0, atol=0)
    kc, kcrash, kmin = fr.rollout_block_minima(dyn, cost, x0, U, DT, split_cost=True)
    pc, pcrash = fr.split_rollout_plain(dyn, cost, x0, U, DT)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    assert torch.equal(kmin, fr.block_minima_plain(pc))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "nln"])
@pytest.mark.parametrize("shape", list(WARP_SHAPES))
@pytest.mark.parametrize("pair", WARP_PAIRS)
def test_split_warp_solve_dynamics_pass_matches_plain(cuda_device, pair, shape, kind):
    """B3's split dynamics pass in its warp form against its plain version:
    U, Y and the per-sample LR sums bit for bit, then the whole split form's
    costs and crash flags; one launch of split_solve_dynamics_warp_kernel."""
    K, p, stride = WARP_SHAPES[shape]
    dyn, cost, x0, _, mean, _ = _warp_inputs(pair, cuda_device, K, p, stride, 37)
    std = _pair_parts(pair, cuda_device)[3]
    kw = dict(std_dev=std, pure_noise_percentage=p, device=cuda_device)
    samp = NLNDistribution.create(**kw) if kind == "nln" else GaussianDistribution.create(**kw)
    seed = torch.tensor(K + 41, dtype=torch.int32, device=cuda_device)
    nk = fr.noise_kind(samp)
    fr.reset_launch_counts()
    kU, kY, klr = fused_solve.split_solve_dynamics_cuda(dyn, cost, samp, nk, x0, mean, seed,
                                                        DT, K, 0, stride, None)
    torch.cuda.synchronize()
    assert fr.launch_counts["split_solve_dynamics_warp_kernel"] == 1
    assert fr.launch_counts["split_solve_dynamics_kernel"] == 0
    pU, plr = fused_solve._samples_plain(dyn, samp, mean, seed, K, 0, stride, None)
    _close(kU, pU, rtol=0, atol=0)
    _close(klr, plr, rtol=0, atol=0)
    _close(kY, fr.split_outputs_plain(dyn, x0, pU, DT).permute(1, 2, 0), rtol=0, atol=0)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    kc, kcrash, _, kcarry = fused_solve.fused_solve_carries(
        *args, optimization_stride=stride, split_cost=True)
    pc, pcrash, _, pcarry = fused_solve.fused_solve_split_plain(
        *args, optimization_stride=stride)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    _close(kcarry, pcarry, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_split_warp_dynamics_pass_per_sample_x0_matches_plain(cuda_device):
    """AutoRally's split dynamics pass from one x0 per sample in its warp
    form at RMPPI's stage-1 shape (9 candidates x 256 samples, T = 150): Y
    bit for bit against the plain version, then the costs and crash flags
    of the whole split form."""
    dyn, cost, x0, std, _ = _pair_parts("ar_nn", cuda_device)
    dx = torch.tensor([0.5, 0.3, 0.1, 0.0, -0.5, 0.0, 0.0], device=cuda_device)
    w = torch.linspace(0.0, 1.0, 9, device=cuda_device)[:, None]
    X0 = (x0[None] + w * dx[None]).repeat_interleave(256, dim=0).contiguous()
    K = X0.shape[0]
    g = torch.Generator(device=cuda_device).manual_seed(43)
    sigma = torch.tensor([std], device=cuda_device).expand(WARP_T, C)
    U = (sigma * torch.randn((K, WARP_T, C), generator=g, device=cuda_device)).contiguous()
    fr.reset_launch_counts()
    Y = fr.split_dynamics_cuda(dyn, cost, X0, U, DT)
    torch.cuda.synchronize()
    assert fr.entry_counts == {"split_dynamics_x0_ar_nn": 1}
    assert fr.launch_counts["split_dynamics_warp_kernel"] == 1
    _close(Y, fr.split_outputs_plain(dyn, X0, U, DT).permute(1, 2, 0), rtol=0, atol=0)
    kc, kcrash = fr.fused_rollout_costs(dyn, cost, X0, U, DT, split_cost=True)
    pc, pcrash = fr.split_rollout_plain(dyn, cost, X0, U, DT)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)



# --- the warp form of B4 and B8 (csrc/sample_warp.cuh, csrc/rmppi_warp.cuh):
# the network pairs at the paths' shapes ---
# (K, T, pure-noise share, stride): K = 1920 fills every block; 1900 and 1901
# leave the last block of 4 (AutoRally) or 8 (racers) warps partly empty,
# with a pure-noise tail and stride 2; K = 3 is one block. T = 150 and 100
# end in a partial chunk of 32 steps, T = 31 is a single partial chunk.
B4_WARP_SHAPES = {"1920x150": (1920, 150, 0.0, 0), "1900x100": (1900, 100, 0.1, 2),
                  "1901x150": (1901, 150, 0.1, 2), "3x31": (3, 31, 0.0, 1)}
# (sampler, epilogue, injected normals)
B4_WARP_MODES = {"gaussian": ("gaussian", False, False), "nln": ("nln", False, False),
                 "smooth": ("smooth", False, False),
                 "smooth_epilogue": ("smooth", True, False),
                 "nln_injected": ("nln", False, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(B4_WARP_MODES))
@pytest.mark.parametrize("shape", list(B4_WARP_SHAPES))
@pytest.mark.parametrize("pair", WARP_PAIRS)
def test_sample_warp_matches_plain(cuda_device, pair, shape, mode):
    """B4's warp form against its plain version: costs, crash flags, U, W
    and (Smooth's epilogue) the 64-sample carry rows bit for bit, the carry
    rows against write_block_carry's order (``fr.block_carries_ordered``);
    one launch of fused_sample_rollout_warp_kernel, and of
    block_carry_tiled_kernel with the epilogue."""
    dev = cuda_device
    K, T_, p, stride = B4_WARP_SHAPES[shape]
    kind, epilogue, inject = B4_WARP_MODES[mode]
    dyn, cost, x0, std, offset = _pair_parts(pair, dev)
    Cp = dyn.CONTROL_DIM
    kw = dict(std_dev=std, control_cost_coeff=[1.0] * Cp, pure_noise_percentage=p, device=dev)
    if kind == "smooth":
        samp = SmoothMPPIDistribution.create(num_timesteps=T_, dt=0.05, **kw)
    else:
        samp = (NLNDistribution if kind == "nln" else GaussianDistribution).create(**kw)
    g = torch.Generator(device=dev).manual_seed(K + T_)
    mean = 0.3 * torch.randn((T_, Cp), generator=g, device=dev)
    mean[:, -1] += offset
    state = 0.3 * torch.randn((T_, Cp), generator=g, device=dev) if kind == "smooth" else None
    z = (torch.randn((2, K, T_, Cp), generator=g, device=dev) if inject else None)
    seed = torch.tensor(K + 7, dtype=torch.int32, device=dev)
    fr.reset_launch_counts()
    kc, kcrash, kU, kW, kcarry = fr._sample_rollout_cuda(
        dyn, cost, samp, fr.noise_kind(samp), x0, mean, seed, DT, LAM, ALPHA, K, 0, stride,
        state, epilogue, True, z)
    torch.cuda.synchronize()
    assert fr.launch_counts["fused_sample_rollout_warp_kernel"] == 1
    assert fr.launch_counts["fused_sample_rollout_kernel"] == 0
    assert fr.launch_counts["block_carry_tiled_kernel"] == int(epilogue)
    assert fr.entry_counts == {f"fused_sample_rollout_{pair}": 1}
    pc, pcrash, pU, pW = fr.sample_rollout_plain(
        dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K, optimization_stride=stride,
        sampler_state=state, injected_noise=z)
    assert torch.isfinite(pc).all()
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    _close(kU, pU, rtol=0, atol=0)
    if kind == "smooth":
        _close(kW, pW, rtol=0, atol=0)
    if epilogue:
        lam = fr._f32(LAM)
        _close(kcarry, fr.block_carries_ordered(pc, pW, lam), rtol=0, atol=0)
        _close(kcarry, fr.block_carries_plain(pc, pW, lam), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1920, 1900, 1901, 3])
@pytest.mark.parametrize("robust", [False, True])
def test_rmppi_warp_autorally_matches_plain(cuda_device, K, robust):
    """B8's warp form for AutoRally with either AR cost on the partly-crashing
    map, T = 150 (a partial last chunk): s_nom, j_real, s_fb, the crash flags
    and U_real bit for bit against the plain version; one launch of
    rmppi_rollout_warp_kernel."""
    dev = cuda_device
    T_ = WARP_T
    dyn = AutorallyNNDynamics(FNN.create([6, 32, 32, 4], seed=0, scale=1.0),
                              control_ranges=[[-0.9, 0.9], [-0.6, 1.0]], device=dev)
    cost = (ARRobustCost if robust else ARStandardCost)(costmap=_partial_map(dev), device=dev)
    g = torch.Generator(device=dev).manual_seed(K + robust)
    U = 0.5 * torch.randn((K, T_, C), generator=g, device=dev)
    gains = -0.5 * torch.rand((T_, C, 7), generator=g, device=dev)
    sigma = torch.tensor([[0.3, 0.5]], device=dev).expand(T_, C).contiguous()
    x_nom = _ar_x0(dev)
    x_real = x_nom + torch.tensor([0.05, -0.04, 0.03, 0.0, 0.2, 0.05, 0.02], device=dev)
    args = (dyn, cost, x_nom, x_real, U, gains, sigma, torch.tensor([0.5, 1.0], device=dev),
            DT, LAM, ALPHA)
    fr.reset_launch_counts()
    kout = fr.fused_rmppi_rollout(*args)
    torch.cuda.synchronize()
    assert fr.launch_counts["rmppi_rollout_warp_kernel"] == 1
    assert fr.launch_counts["rmppi_rollout_kernel"] == 0
    pout = fr.rmppi_rollout_plain(*args)
    for k, p in zip(kout[:3], pout[:3]):
        assert torch.isfinite(p).all()
        _close(k, p, rtol=0, atol=0)
    assert torch.equal(kout[3], pout[3])
    _close(kout[4], pout[4], rtol=0, atol=0)


@pytest.mark.cuda
def test_sample_and_rmppi_entries_report_their_form(cuda_device):
    """The network pairs' B4 and B8 entries (and the racer suspension
    model's B4) launch the warp form, every other pair's B4 and B8 the
    staged form (``<entry>_form``), but B8 of
    the bicycle (its cost's sticky crash) and of the quadrotor (its two
    staged stages would pass 227 KB of shared memory): the one-thread
    kernel (``rmppi_form``)."""
    from mppi_generic_tpu_torch.ops import _build

    one_thread_b8 = ("bicycle_ar", "quadrotor_quadratic", "quadrotor_map")
    for pair in _build.PAIR_KERNELS:
        for kind, base in (("sample", "fused_sample_rollout"), ("rmppi", "rmppi_rollout")):
            entry = _build.pair_entry(pair, kind)
            if entry is None:
                continue
            warp = pair in WARP_PAIRS + FAMILY_WARP_PAIRS
            want = f"{base}_warp_kernel" if warp else f"{base}_staged_kernel"
            if kind == "rmppi" and pair in one_thread_b8:
                want = f"{base}_kernel"
            assert fr.form_kernel_name(base, entry) == want, (pair, kind)


# --- B7's warp recursion (csrc/riccati_kernels.cuh riccati_ladder_warp_kernel)
# and B4's staged form (csrc/sample_staged.cuh) ---
def _di_ladder_problem(dev, T_):
    """The first iLQR iteration's ladder inputs for the double integrator,
    in _model_ladder_problem's form."""
    dyn = DoubleIntegratorDynamics.create(device=dev)
    g = torch.Generator(device=dev).manual_seed(T_ + 1)
    lo, hi = (torch.nan_to_num(dyn.control_ranges[:, i], neginf=-1e30, posinf=1e30).contiguous()
              for i in (0, 1))
    us = 0.4 * torch.randn((T_, C), generator=g, device=dev)
    xs = [torch.tensor([2.0, 0.0, 0.0, 2.0], device=dev)]
    for t in range(T_ - 1):
        xs.append(xs[-1] + dyn.state_deriv(xs[-1], us[t]) * DT)
    xs = torch.stack(xs)
    goal_x = xs + 0.05 * torch.randn((T_, 4), generator=g, device=dev)
    goal_u = torch.zeros((T_, C), device=dev)
    Q, R = torch.eye(4, device=dev), 0.5 * torch.eye(C, device=dev)
    Qf = 3 * Q
    lin = linearize(dyn, xs, us, goal_x, goal_u, Q, R, Qf, DT)
    return dyn, (xs, us, *lin[:4], Q, R, Qf, lin[4], lin[5], goal_x, goal_u,
                 _alpha_ladder(device=dev), lo, hi, DT)


# (model, T): the ragged horizons for each model, then the horizons past
# 48 KB of shared memory, where the launch takes the opt-in: the gains and
# the staged tables (T (C S + C + 2 (S + C)) floats) under 48 KB with the
# model's table and the recursion's over it (the DI at T = 552, AutoRally at
# 340), and the tables alone over it up to the longest horizon (T = 1024)
LADDER_WARP_CASES = ([(kind, T_) for kind in ("di", "cartpole", "autorally")
                      for T_ in (31, 33, 100, 150)]
                     + [("di", 552), ("di", 1024), ("autorally", 340), ("autorally", 1024)])


@pytest.mark.cuda
@pytest.mark.parametrize("n_alpha", [1, 14, 33, 128])
@pytest.mark.parametrize("kind,T_", LADDER_WARP_CASES)
def test_ladder_warp_matches_plain_and_b6(cuda_device, kind, T_, n_alpha):
    """B7's warp form against its plain version at ragged line searches
    (n_alpha 1, 14, 33 and the most, 128) and horizons, up to the longest
    the kernels take and across the shared-memory opt-in: gains, feedforward,
    costs, xs_new and us_new bit for bit, and the gains and feedforward
    equal to B6's (the one-thread recursion) on the same linearisation; one
    launch of riccati_ladder_warp_kernel."""
    dev = cuda_device
    dyn, args = (_di_ladder_problem(dev, T_) if kind == "di"
                 else _model_ladder_problem(kind, dev, T_))
    args = list(args)
    args[13] = _alpha_ladder(n_alpha, device=dev)
    riccati.reset_launch_counts()
    kout = riccati.riccati_ladder_solve(dyn, *args)
    torch.cuda.synchronize()
    assert riccati.launch_counts["riccati_ladder_warp_kernel"] == 1
    assert riccati.launch_counts["riccati_ladder_kernel"] == 0
    xs, us, As, Bs, dLx, dLu, Q, R, Qf, Vxx_T, Vx_T, goal_x, goal_u, alphas, lo, hi, _ = args
    pK, pk = riccati.riccati_backward_plain(As, Bs, dLx, dLu, Q * DT, R * DT, Vxx_T,
                                            Vx_T, DT, 1e-6)
    pout = (pK, pk) + riccati.ladder_forward_plain(
        dyn, xs, us, pK, pk, goal_x, goal_u, Q, R, Qf, alphas, torch.stack([lo, hi]), DT)
    for got, want in zip(kout, pout):
        assert torch.isfinite(want).all()
        _close(got, want, rtol=0, atol=0)
    bK, bk = riccati.riccati_backward(As, Bs, dLx, dLu, Q, R, Vxx_T, Vx_T, DT)
    torch.cuda.synchronize()
    assert torch.equal(kout[0], bK) and torch.equal(kout[1], bk)


STAGED_PAIRS = ["di_circle", "di_quadratic", "di_robust", "cartpole", "quadrotor_quadratic",
                "quadrotor_map", "dubins_quadratic", "bicycle_ar"]
# (K, T, pure-noise share, stride): 65 and 63 leave the last 64-sample block
# partly empty, 1 is a single sample, 1901 the bicycle loop's ragged K, 8000
# the DI's; T = 33 ends in a chunk of one step, 31 is one partial chunk,
# 100 and 150 end in a partial chunk of 32 steps
STAGED_SHAPES = {"65x33": (65, 33, 0.1, 2), "1x31": (1, 31, 0.0, 1),
                 "63x100": (63, 100, 0.1, 2), "1901x150": (1901, 150, 0.1, 2),
                 "8000x100": (8000, 100, 0.0, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(B4_WARP_MODES))
@pytest.mark.parametrize("shape", list(STAGED_SHAPES))
@pytest.mark.parametrize("pair", STAGED_PAIRS)
def test_sample_staged_matches_plain(cuda_device, pair, shape, mode):
    """B4's staged form against its plain version: costs, crash flags, U, W
    and (Smooth's epilogue) the 64-sample carry rows bit for bit, the carry
    rows in write_block_carry's order (``fr.block_carries_ordered``); one
    launch of fused_sample_rollout_staged_kernel and no carry pass."""
    dev = cuda_device
    K, T_, p, stride = STAGED_SHAPES[shape]
    kind, epilogue, inject = B4_WARP_MODES[mode]
    dyn, cost, x0, std, offset = _pair_parts(pair, dev)
    Cp = dyn.CONTROL_DIM
    kw = dict(std_dev=std, control_cost_coeff=[1.0] * Cp, pure_noise_percentage=p, device=dev)
    if kind == "smooth":
        samp = SmoothMPPIDistribution.create(num_timesteps=T_, dt=0.05, **kw)
    else:
        samp = (NLNDistribution if kind == "nln" else GaussianDistribution).create(**kw)
    g = torch.Generator(device=dev).manual_seed(K + T_ + 3)
    mean = 0.3 * torch.randn((T_, Cp), generator=g, device=dev)
    mean[:, -1] += offset
    state = 0.3 * torch.randn((T_, Cp), generator=g, device=dev) if kind == "smooth" else None
    z = torch.randn((2, K, T_, Cp), generator=g, device=dev) if inject else None
    seed = torch.tensor(K + 9, dtype=torch.int32, device=dev)
    fr.reset_launch_counts()
    kc, kcrash, kU, kW, kcarry = fr._sample_rollout_cuda(
        dyn, cost, samp, fr.noise_kind(samp), x0, mean, seed, DT, LAM, ALPHA, K, 0, stride,
        state, epilogue, True, z)
    torch.cuda.synchronize()
    assert fr.launch_counts["fused_sample_rollout_staged_kernel"] == 1
    assert fr.launch_counts["fused_sample_rollout_kernel"] == 0
    assert fr.launch_counts["block_carry_kernel"] == 0
    assert fr.launch_counts["block_carry_tiled_kernel"] == 0
    assert fr.entry_counts == {f"fused_sample_rollout_{pair}": 1}
    pc, pcrash, pU, pW = fr.sample_rollout_plain(
        dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K, optimization_stride=stride,
        sampler_state=state, injected_noise=z)
    assert torch.isfinite(pc).all()
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    _close(kU, pU, rtol=0, atol=0)
    if kind == "smooth":
        _close(kW, pW, rtol=0, atol=0)
    if epilogue:
        lam = fr._f32(LAM)
        _close(kcarry, fr.block_carries_ordered(pc, pW, lam), rtol=0, atol=0)
        _close(kcarry, fr.block_carries_plain(pc, pW, lam), rtol=1e-5, atol=1e-5)


# --- B3's and B1's staged forms (csrc/sample_staged.cuh: fused_solve_staged_kernel,
# rollout_costs_staged_kernel) ---
@pytest.mark.cuda
def test_solve_and_rollout_entries_report_their_form(cuda_device):
    """Every B3 and B1 entry of a pair without a network step launches the
    staged form; the network pairs' B3 and B1 (AutoRally's per-sample-x0 B1
    too) the warp form (``<entry>_form``)."""
    from mppi_generic_tpu_torch.ops import _build

    for pair in _build.PAIR_KERNELS:
        for kind, base in (("solve", "fused_solve"), ("rollout", "rollout_costs"),
                           ("rollout_x0", "rollout_costs")):
            entry = _build.pair_entry(pair, kind)
            if entry is None:
                continue
            staged = pair in STAGED_PAIRS + FAMILY_STAGED_PAIRS
            want = base + ("_staged_kernel" if staged else "_warp_kernel")
            assert fr.form_kernel_name(base, entry) == want, (pair, kind)


SOLVE_STAGED_MODES = {"gaussian": ("gaussian", False), "nln": ("nln", False),
                      "nln_injected": ("nln", True)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(SOLVE_STAGED_MODES))
@pytest.mark.parametrize("shape", list(STAGED_SHAPES))
@pytest.mark.parametrize("pair", STAGED_PAIRS)
def test_solve_staged_matches_plain(cuda_device, pair, shape, mode):
    """B3's staged form against its plain version: costs, crash flags, U and
    the 64-sample carry rows (in write_block_carry's order,
    ``fr.block_carries_ordered``) bit for bit; one launch of
    fused_solve_staged_kernel."""
    dev = cuda_device
    K, T_, p, stride = STAGED_SHAPES[shape]
    kind, inject = SOLVE_STAGED_MODES[mode]
    dyn, cost, x0, std, offset = _pair_parts(pair, dev)
    Cp = dyn.CONTROL_DIM
    samp = (NLNDistribution if kind == "nln" else GaussianDistribution).create(
        std_dev=std, control_cost_coeff=[1.0] * Cp, pure_noise_percentage=p, device=dev)
    g = torch.Generator(device=dev).manual_seed(K + T_ + 5)
    mean = 0.3 * torch.randn((T_, Cp), generator=g, device=dev)
    mean[:, -1] += offset
    z = torch.randn((2, K, T_, Cp), generator=g, device=dev) if inject else None
    seed = torch.tensor(K + 11, dtype=torch.int32, device=dev)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    kw = dict(iteration=1, optimization_stride=stride, injected_noise=z)
    fr.reset_launch_counts()
    kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, split_cost=False, **kw)
    torch.cuda.synchronize()
    assert fr.launch_counts["fused_solve_staged_kernel"] == 1
    assert fr.launch_counts["fused_solve_kernel"] == 0
    assert fr.entry_counts == {f"fused_solve_{pair}": 1}
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, **kw)
    assert torch.isfinite(pc).all()
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    _close(kU, pU, rtol=0, atol=0)
    lam = fr._f32(LAM)
    _close(kcarry, fr.block_carries_ordered(pc, pU, lam), rtol=0, atol=0)
    _close(kcarry, pcarry, rtol=1e-5, atol=1e-5)


# B1's modes: (epilogue, with LR, one x0 per sample); the per-sample-x0
# entries (rollout_x0.cu) are the DI circle's, the DI robust's and the
# bicycle's, and the DI robust cost has only those
ROLLOUT_STAGED_MODES = {
    "costs": (fr.EPI_NONE, False, False), "costs+lr": (fr.EPI_NONE, True, False),
    "epilogue": (fr.EPI_EXP, False, False), "epilogue+lr": (fr.EPI_EXP, True, False),
    "tsallis+lr": (fr.EPI_MIN, True, False), "x0": (fr.EPI_NONE, False, True),
    "x0 epilogue+lr": (fr.EPI_EXP, True, True)}
ROLLOUT_X0_PAIRS = ("di_circle", "di_robust", "bicycle_ar")
ROLLOUT_STAGED_CASES = [
    (pair, mode) for pair in STAGED_PAIRS for mode, (_, _, x0s) in ROLLOUT_STAGED_MODES.items()
    if (pair in ROLLOUT_X0_PAIRS if x0s else pair != "di_robust")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(STAGED_SHAPES))
@pytest.mark.parametrize("pair,mode", ROLLOUT_STAGED_CASES)
def test_rollout_staged_matches_plain(cuda_device, pair, mode, shape):
    """B1's staged form against its plain version: costs, crash flags, the
    carry rows (in write_block_carry's order) and the block minima bit for
    bit, from one x0 or one per sample; one launch of
    rollout_costs_staged_kernel."""
    dev = cuda_device
    K, T_, p, _ = STAGED_SHAPES[shape]
    epilogue, with_lr, x0s = ROLLOUT_STAGED_MODES[mode]
    dyn, cost, x0, std, offset = _pair_parts(pair, dev)
    Cp = dyn.CONTROL_DIM
    g = torch.Generator(device=dev).manual_seed(K + T_ + 7)
    mean = 0.3 * torch.randn((T_, Cp), generator=g, device=dev)
    mean[:, -1] += offset
    sigma = torch.tensor([std], device=dev).expand(T_, Cp).contiguous()
    U = (mean + sigma * torch.randn((K, T_, Cp), generator=g, device=dev)).contiguous()
    lr = ((mean, sigma, torch.full((Cp,), 0.5, device=dev), LAM, ALPHA,
           float((np.float32(1) - np.float32(p)) * np.float32(K))) if with_lr else None)
    if x0s:
        x0 = (x0 + 0.05 * torch.randn((K, x0.numel()), generator=g, device=dev)).contiguous()
    fr.reset_launch_counts()
    kc, kcrash, kout = fr._rollout_cuda(dyn, cost, x0, U, DT, lr, epilogue, LAM)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_staged_kernel"] == 1
    assert fr.launch_counts["rollout_costs_kernel"] == 0
    prefix = "rollout_costs_x0_" if x0s else "rollout_costs_"
    assert fr.entry_counts == {prefix + pair: 1}
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    assert torch.isfinite(pc).all()
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    if epilogue == fr.EPI_EXP:
        _close(kout, fr.block_carries_ordered(pc, U, fr._f32(LAM)), rtol=0, atol=0)
    elif epilogue == fr.EPI_MIN:
        assert torch.equal(kout, fr.block_minima_plain(pc))


# --- the merge's tiled form and the split cost pass's cluster form, against
# their plain versions and the earlier forms' build (chip_smoke.EARLIER_DEFINES:
# -DMPPI_COMBINE_ONE_BLOCK, -DMPPI_COST_ONE_BLOCK) ---
@pytest.fixture(scope="module")
def earlier_forms():
    """The earlier forms' build of chip_smoke.EARLIER_SOURCES, loaded beside
    the port's, and chip_smoke (its ``swapped`` points the wrappers at it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke

    libs = {}
    chip_smoke.build_variants(((libs, chip_smoke.EARLIER_DEFINES, "earlier_forms_test",
                                chip_smoke.EARLIER_SOURCES),))
    return chip_smoke, libs


def _same(a, b):
    """Bit for bit, NaN where the other is NaN."""
    return torch.equal(a, b) or (torch.equal(torch.isnan(a), torch.isnan(b))
                                 and torch.equal(a.nan_to_num(), b.nan_to_num()))


@pytest.mark.cuda
@pytest.mark.parametrize("nb,TC,kind", [
    (128, 200, "flash"), (30, 300, "flash"), (128, 400, "flash"), (128, 100, "flash"),
    (128, 200, "tsallis"), (30, 300, "tsallis"), (129, 200, "flash"), (1, 100, "flash"),
    (300, 300, "tsallis"), (30, 300, "masked"), (128, 200, "nan")])
def test_tiled_merge_matches_the_one_block_build(cuda_device, earlier_forms, nb, TC, kind):
    """The tiled merge against the one-block build bit for bit (new mean,
    baseline, eta, num) and against flash_combine_plain: new mean rtol 1e-4
    / atol 1e-5, baseline rtol 1e-6, eta rtol 1e-5."""
    from test_torch_tiled_merge import carry_rows

    smoke, libs = earlier_forms
    carry = carry_rows(nb, TC, kind, seed=nb + TC).to(cuda_device)
    T_, C_ = TC // 2, 2
    fr.reset_launch_counts()
    got = fr.flash_combine(carry, T_, C_, LAM, with_num=True)
    with smoke.swapped(libs):
        one = fr.flash_combine(carry, T_, C_, LAM, with_num=True)
    torch.cuda.synchronize()
    assert {k: v for k, v in fr.launch_counts.items() if v} == {
        "flash_combine_tiled_kernel": 1, "flash_combine_kernel": 1}
    assert all(_same(a, b) for a, b in zip(got, one))
    if kind == "nan":
        assert torch.isnan(got[0]).all() and torch.isnan(got[2])
        return
    want = fr.flash_combine_plain(carry, T_, C_, fr._f32(LAM))
    _close(got[0], want[0], rtol=1e-4, atol=1e-5)
    _close(got[1], want[1], rtol=1e-6, atol=0)
    _close(got[2], want[2], rtol=1e-5, atol=0)


CLUSTER_PAIRS = ["di_circle", "ar_nn", "ar_nn_robust", "bicycle_ar", "racer_steering_ar",
                 "racer_unc_ar"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["costs", "costs+lr", "epilogue+lr", "tsallis+lr", "b3"])
@pytest.mark.parametrize("K_,T_", [(70, 150), (70, 100), (70, 31), (70, 7), (1901, 150)])
@pytest.mark.parametrize("pair", CLUSTER_PAIRS)
def test_cluster_cost_matches_plain_and_the_one_block_build(cuda_device, earlier_forms, pair,
                                                            K_, T_, mode):
    """The cluster cost pass on the port's dynamics pass's outputs: costs,
    crash flags and block minima bit for bit against the plain cost pass
    (split_step_values_plain, split_sums_plain) on the same Y, the carry
    rows within rtol 1e-5 of block_carries_plain, and every output bit for
    bit against the one-block build; "b3" adds B3's per-sample LR sums."""
    smoke, libs = earlier_forms
    base = "ar_nn" if pair == "ar_nn_robust" else pair
    dyn, cost, x0, std, _ = _pair_parts(base, cuda_device)
    if pair == "ar_nn_robust":
        cost = ARRobustCost(costmap=cost.costmap, device=cuda_device)
    Cp = dyn.CONTROL_DIM
    g = torch.Generator(device=cuda_device).manual_seed(K_ + T_)
    mean = 0.2 * torch.randn((T_, Cp), generator=g, device=cuda_device)
    sigma = torch.tensor([std], device=cuda_device).expand(T_, Cp).contiguous()
    U = (mean + sigma * torch.randn((K_, T_, Cp), generator=g, device=cuda_device)).contiguous()
    lr = ((mean, sigma, torch.full((Cp,), 0.5, device=cuda_device), LAM, ALPHA, 0.9 * K_)
          if mode.endswith("+lr") else None)
    lr_sum = (torch.randn((K_,), generator=g, device=cuda_device) if mode == "b3"
              else None)
    epilogue = {"costs": fr.EPI_NONE, "tsallis": fr.EPI_MIN}.get(mode.split("+")[0],
                                                                 fr.EPI_EXP)
    Y = fr.split_dynamics_cuda(dyn, cost, x0, U, DT)
    args = (dyn, cost, Y, U, lr, epilogue, LAM, lr_sum, 0.37 if mode == "b3" else 0.0)
    fr.reset_launch_counts()
    got = fr.split_cost_cuda(*args, form=3)
    with smoke.swapped(libs):
        one = fr.split_cost_cuda(*args)
    torch.cuda.synchronize()
    assert fr.launch_counts["split_cost_cluster_kernel"] == 1
    assert fr.launch_counts["split_cost_kernel"] == 1
    for a, b in zip(got, one):
        assert (a is None and b is None) or _same(a, b)
    Yk = Y.permute(2, 0, 1)
    acc, crash = fr.split_sums_plain(*fr.split_step_values_plain(cost, Yk, U, lr))
    acc = acc + cost.terminal_cost(Yk[:, -1].T)
    if lr_sum is not None:
        acc = acc + 0.37 * lr_sum
    costs = true_div(acc, T_)
    assert _same(got[0], costs)
    assert torch.equal(got[1], crash)
    if epilogue == fr.EPI_EXP:
        _close(got[2], fr.block_carries_plain(costs, U, LAM), rtol=1e-5, atol=1e-5)
    elif epilogue == fr.EPI_MIN:
        assert torch.equal(got[2], fr.block_minima_plain(costs))


@pytest.mark.cuda
@pytest.mark.parametrize("pair,T_", [("ar_nn", 20), ("di_circle", 100), ("di_circle", 48)])
def test_cost_pass_launches_the_form_its_rule_picks(cuda_device, earlier_forms, pair, T_):
    """The cost pass launches its cluster form while its 8 CTAs a 64-sample
    block number at most three a multiprocessor and the cost is dual
    (AutoRally's) or its chunks hold 8 steps or more, the one-block form
    otherwise; both give the earlier build's outputs bit for bit."""
    smoke, libs = earlier_forms
    dyn, cost, x0, _, _ = _pair_parts(pair, cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    last = (3 * sms // fr.COST_CLUSTER) * fr.BLOCK  # the largest K of the cluster form
    long_chain = pair == "ar_nn" or T_ >= 57
    for K_, cluster in ((last, long_chain), (last + 1, False), (8192, False)):
        form = "split_cost_cluster_kernel" if cluster else "split_cost_kernel"
        U = torch.randn((K_, T_, C), device=cuda_device)
        Y = fr.split_dynamics_cuda(dyn, cost, x0, U, DT)
        fr.reset_launch_counts()
        got = fr.split_cost_cuda(dyn, cost, Y, U, None, fr.EPI_EXP, LAM)
        with smoke.swapped(libs):
            one = fr.split_cost_cuda(dyn, cost, Y, U, None, fr.EPI_EXP, LAM)
        torch.cuda.synchronize()
        assert fr.launch_counts[form] == 1 + (not cluster), K_
        assert all(_same(a, b) for a, b in zip(got, one)), K_


# --- B8's staged form (csrc/rmppi_staged.cuh) and the bicycle's lane-group
# split dynamics pass (csrc/split_lanes.cuh), against their plain versions
# and their one-thread builds (chip_smoke.py's -DMPPI_RMPPI_ONE_THREAD and
# -DMPPI_SPLIT_ONE_THREAD) ---
@pytest.fixture(scope="module")
def one_thread_b8_lanes():
    """The one-thread builds of rmppi_rollout.cu and split_bicycle_ar.cu,
    loaded beside the port's, and chip_smoke (its ``swapped`` points the
    wrappers at them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke

    libs = {}
    chip_smoke.build_variants((
        (libs, ("MPPI_RMPPI_ONE_THREAD",), "rmppi_one_thread_test", ("rmppi_rollout",)),
        (libs, ("MPPI_SPLIT_ONE_THREAD",), "lanes_one_thread_test", ("split_bicycle_ar",))))
    return chip_smoke, libs


def _rmppi_inputs(kind, K, T_, dev, seed):
    """B8's inputs for the DI with its circle or robust cost (discount 0.95:
    the crash term's discount^t is not 1): raw samples, gains, sigma,
    coefficients."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dyn = DoubleIntegratorDynamics.create(control_ranges=[[-2.5, 2.5], [-2.0, 2.0]],
                                          control_deadband=[0.05, 0.1], device=dev)
    if kind == "robust":
        cost = DoubleIntegratorRobustCost(discount=0.95, device=dev)
        x_nom, x_real = [2.05, 0.0, 0.0, 1.9], [2.12, -0.05, 0.1, 1.8]
    else:
        cost = DoubleIntegratorCircleCost(discount=0.95, device=dev)
        x_nom, x_real = [2.0, 0.0, 0.0, 1.0], [2.15, -0.05, 0.1, 0.9]
    U = 1.2 * torch.randn((K, T_, C), generator=g, device=dev)
    gains = -0.8 * torch.rand((T_, C, 4), generator=g, device=dev)
    sigma = 0.6 + 0.8 * torch.rand((T_, C), generator=g, device=dev)
    return (dyn, cost, torch.tensor(x_nom, device=dev), torch.tensor(x_real, device=dev), U,
            gains, sigma, torch.tensor([0.02, 0.5], device=dev), DT, LAM, ALPHA)


@pytest.mark.cuda
@pytest.mark.parametrize("K_,T_", [(2560, 50), (2500, 50), (256, 48), (250, 48), (130, 31),
                                   (64, 100), (1, 33)])
@pytest.mark.parametrize("kind", ["circle", "robust"])
def test_rmppi_staged_matches_plain_and_the_one_thread_build(cuda_device, one_thread_b8_lanes,
                                                             kind, K_, T_):
    """B8's staged form against its plain version and the one-thread build:
    s_nom, j_real, s_fb, the crash flags and U_real bit for bit at the
    paths' shapes (``rmppi`` 2560 x 50, ``rmppi_di_robust`` 256 x 48), their
    ragged K, a ragged T and a horizon that refills each stage (100); one
    launch of rmppi_rollout_staged_kernel."""
    smoke, libs = one_thread_b8_lanes
    args = _rmppi_inputs(kind, K_, T_, cuda_device, K_ + T_)
    fr.reset_launch_counts()
    got = fr.fused_rmppi_rollout(*args)
    torch.cuda.synchronize()
    assert fr.launch_counts["rmppi_rollout_staged_kernel"] == 1
    assert fr.launch_counts["rmppi_rollout_kernel"] == 0
    with smoke.swapped(libs):
        one = fr.fused_rmppi_rollout(*args)
    want = fr.rmppi_rollout_plain(*args)
    torch.cuda.synchronize()
    assert fr.launch_counts["rmppi_rollout_kernel"] == 1
    for name, a, b, c in zip(("s_nom", "j_real", "s_fb", "crash", "U_real"), got, one, want):
        assert torch.equal(a, c), name
        assert torch.equal(b, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("K_,T_", [(1920, 100), (1901, 100), (130, 31), (3, 33)])
def test_split_lanes_matches_plain_and_the_one_thread_build(cuda_device, one_thread_b8_lanes,
                                                            K_, T_):
    """The bicycle's split dynamics pass in its lane-group form against its
    plain version and the one-thread build: Y (T, O, K) bit for bit at the
    path's shape (1920 x 100), the ragged one, a ragged T and a partly empty
    block; one launch of split_dynamics_lanes_kernel."""
    smoke, libs = one_thread_b8_lanes
    dyn, cost, x0, std, _ = _pair_parts("bicycle_ar", cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(K_ + T_)
    U = (torch.tensor(std, device=cuda_device) * torch.randn((K_, T_, 2), generator=g,
                                                             device=cuda_device))
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    fr.reset_launch_counts()
    Y = fr.split_dynamics_cuda(dyn, cost, x0, U, DT)
    torch.cuda.synchronize()
    assert fr.launch_counts["split_dynamics_lanes_kernel"] == 1
    assert fr.launch_counts["split_dynamics_kernel"] == 0
    with smoke.swapped(libs):
        one = fr.split_dynamics_cuda(dyn, cost, x0, U, DT)
    pY = fr.split_outputs_plain(dyn, x0, U, DT).permute(1, 2, 0)
    torch.cuda.synchronize()
    assert fr.launch_counts["split_dynamics_kernel"] == 1
    assert torch.isfinite(pY).all()
    assert torch.equal(Y, pY) and torch.equal(one, pY)


@pytest.mark.cuda
def test_b8_and_lanes_builds_report_their_form(cuda_device, one_thread_b8_lanes):
    """The DI's B8 entries report the staged form and the bicycle's B1
    split dynamics pass the lane-group form in the port's build, the
    one-thread kernels in the one-thread builds."""
    smoke, libs = one_thread_b8_lanes
    entries = [(_build.pair_entry(p, "rmppi"), "rmppi_rollout") for p in ("di_circle", "di_robust")]
    entries.append((_build.pair_entry("bicycle_ar", "split_dynamics"), "split_dynamics"))
    for entry, base in entries:
        port = fr.form_kernel_name(base, entry)
        with smoke.swapped(libs):
            one = fr.form_kernel_name(base, entry)
        assert one == base + "_kernel", entry
        assert port == base + ("_lanes_kernel" if base == "split_dynamics" else "_staged_kernel")


# --- B3's warp form for the network pairs (csrc/sample_warp.cuh
# fused_solve_warp_kernel, then the carry pass) and the tiled B5
# (csrc/tsallis_reduce.cu tsallis_reduce_tiled_kernel), against their plain
# versions and their earlier builds (chip_smoke.py's -DMPPI_SOLVE_ONE_THREAD
# over the network pairs' sources, -DMPPI_TSALLIS_ONE_BLOCK) ---
@pytest.fixture(scope="module")
def one_thread_solve_tsallis():
    """The network pairs' B3 one thread a sample and the one-block Tsallis
    reduction, built beside the port's, and chip_smoke (its ``swapped``
    points the wrappers at them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke

    libs = {}
    chip_smoke.build_variants((
        (libs, ("MPPI_SOLVE_ONE_THREAD",), "solve_one_thread_test",
         tuple(_build.pair_entry(p, "solve")[0] for p in WARP_PAIRS)),
        (libs, ("MPPI_TSALLIS_ONE_BLOCK",), "tsallis_one_block_test", ("tsallis_reduce",))))
    return chip_smoke, libs


def _solve_warp_parts(pair, map_kind, dev):
    """(dynamics, cost, x0, control std) of a network pair: AutoRally's bench
    network on the bench's 128^2 map or its 4 x 1024^2 channel-major map
    (every sample crashes), or a stronger network on the partly-crashing
    map; the racer rows' models (``_racer_parts``)."""
    if pair != "ar_nn":
        return (*_racer_parts(pair.split("_")[1], dev), [0.3, 0.5])
    if map_kind == "partial":
        dyn = AutorallyNNDynamics(FNN.create([6, 32, 32, 4], seed=0, scale=1.0),
                                  control_ranges=[[-0.9, 0.9], [-0.6, 1.0]], device=dev)
        return dyn, ARStandardCost(costmap=_partial_map(dev), device=dev), _ar_x0(dev), [0.3,
                                                                                          0.5]
    if map_kind == "1024":
        chw = np.random.default_rng(3).normal(size=(4, 1024, 1024)).astype("f")
        chw[0] = np.abs(chw[0])
        tex = MapTexture2D(chw, origin=(-51.2, -51.2, 0.0), resolution=0.1,
                           channel_major=True, device=dev)
    else:
        tex = _ar_map("plain", dev)
    return (AutorallyNNDynamics.create(seed=0, device=dev),
            ARStandardCost(costmap=tex, device=dev), _ar_x0(dev), [0.3, 0.5])


# (pair, map, K, T, pure-noise share, stride): the paths' shapes (AutoRally
# 1920 x 150 on both bench maps, racer steering 1920 x 100, racer uncertainty
# 1920 x 150), the partly-crashing map, K = 1900 and 1901 (the last block of
# 4 or 8 warps partly empty) and T = 31 (one partial chunk)
SOLVE_WARP_CASES = {
    "ar 128 1920x150": ("ar_nn", "128", 1920, 150, 0.0, 0),
    "ar 1024 1920x150": ("ar_nn", "1024", 1920, 150, 0.0, 0),
    "ar partial 1920x150": ("ar_nn", "partial", 1920, 150, 0.1, 2),
    "ar partial 1900x150": ("ar_nn", "partial", 1900, 150, 0.1, 2),
    "ar partial 1901x31": ("ar_nn", "partial", 1901, 31, 0.1, 1),
    "steering 1920x100": ("racer_steering_ar", None, 1920, 100, 0.0, 0),
    "steering 1901x31": ("racer_steering_ar", None, 1901, 31, 0.1, 2),
    "unc 1920x150": ("racer_unc_ar", None, 1920, 150, 0.0, 0),
    "unc 1900x150": ("racer_unc_ar", None, 1900, 150, 0.1, 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(SOLVE_STAGED_MODES))
@pytest.mark.parametrize("case", list(SOLVE_WARP_CASES))
def test_solve_warp_matches_plain_and_the_one_thread_build(cuda_device, one_thread_solve_tsallis,
                                                           case, mode):
    """B3's warp form against its plain version and the one-thread build:
    costs, crash flags, U and the carry rows (in write_block_carry's order)
    bit for bit, and so the new mean, baseline and eta of the merge; one
    launch of fused_solve_warp_kernel and one of block_carry_tiled_kernel."""
    smoke, libs = one_thread_solve_tsallis
    dev = cuda_device
    pair, map_kind, K, T_, p, stride = SOLVE_WARP_CASES[case]
    kind, inject = SOLVE_STAGED_MODES[mode]
    dyn, cost, x0, std = _solve_warp_parts(pair, map_kind, dev)
    samp = (NLNDistribution if kind == "nln" else GaussianDistribution).create(
        std_dev=std, control_cost_coeff=[1.0, 0.5], pure_noise_percentage=p, device=dev)
    g = torch.Generator(device=dev).manual_seed(K + T_ + 17)
    mean = 0.3 * torch.randn((T_, C), generator=g, device=dev)
    z = torch.randn((2, K, T_, C), generator=g, device=dev) if inject else None
    seed = torch.tensor(K + 19, dtype=torch.int32, device=dev)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    kw = dict(iteration=1, optimization_stride=stride, injected_noise=z)
    fr.reset_launch_counts()
    got = fused_solve.fused_solve_carries(*args, split_cost=False, **kw)
    torch.cuda.synchronize()
    assert {k: v for k, v in fr.launch_counts.items() if v} == {
        "fused_solve_warp_kernel": 1, "block_carry_tiled_kernel": 1}
    assert fr.entry_counts == {f"fused_solve_{pair}": 1}
    with smoke.swapped(libs):
        one = fused_solve.fused_solve_carries(*args, split_cost=False, **kw)
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, **kw)
    torch.cuda.synchronize()
    assert fr.launch_counts["fused_solve_kernel"] == 1
    assert torch.isfinite(pc).all()
    want = (pc, pcrash, pU, fr.block_carries_ordered(pc, pU, fr._f32(LAM)))
    for name, a, b, c in zip(("costs", "crash", "U", "carry"), got, one, want):
        assert torch.equal(a, c), name
        assert torch.equal(b, c), name
    _close(got[3], pcarry, rtol=1e-5, atol=1e-5)
    merged = fr.flash_combine(got[3], T_, C, LAM)
    for a, b in zip(merged, fr.flash_combine(one[3], T_, C, LAM)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_solve_warp_builds_report_their_form(cuda_device, one_thread_solve_tsallis):
    """The network pairs' B3 entries report the warp form in the port's
    build and the one-thread kernel with -DMPPI_SOLVE_ONE_THREAD; the
    Tsallis reduction the tiled form and the one-block kernel."""
    smoke, libs = one_thread_solve_tsallis
    for pair in WARP_PAIRS:
        entry = _build.pair_entry(pair, "solve")
        assert fr.form_kernel_name("fused_solve", entry) == "fused_solve_warp_kernel"
        with smoke.swapped(libs):
            assert fr.form_kernel_name("fused_solve", entry) == "fused_solve_kernel"
    assert fr.tsallis_kernel_name() == "tsallis_reduce_tiled_kernel"
    with smoke.swapped(libs):
        assert fr.tsallis_kernel_name() == "tsallis_reduce_kernel"


# (K, K_valid, T, C): the colored row's 8192 x 100 (128 x 4 tiles of 52
# columns), a ragged K_valid, the bicycle's 1920 x 100, T = 150 (tiles of 60),
# T*C = 62 and 66 (4-byte pieces; 66 in tiles of 36 and 30), C = 1
TSALLIS_TILED_SHAPES = [(8192, 8192, 100, 2), (8192, 8000, 100, 2), (1920, 1920, 100, 2),
                        (1920, 1901, 150, 2), (300, 250, 31, 2), (200, 130, 33, 2),
                        (256, 256, 100, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("gamma,r", [(10.0, 2.0), (0.12, 2.4)])
@pytest.mark.parametrize("K_,K_valid,T_,C_", TSALLIS_TILED_SHAPES)
def test_tsallis_tiled_matches_plain_and_the_one_block_build(cuda_device,
                                                              one_thread_solve_tsallis, K_,
                                                              K_valid, T_, C_, gamma, r):
    """The tiled Tsallis reduction against tsallis_rows_plain and the
    one-block build: rows and rho bit for bit, from the block minima and
    from a given rho; one launch of tsallis_reduce_tiled_kernel."""
    smoke, libs = one_thread_solve_tsallis
    g = torch.Generator(device=cuda_device).manual_seed(K_ + T_)
    U = torch.randn((K_, T_, C_), generator=g, device=cuda_device)
    costs = 1.0 + torch.rand((K_,), generator=g, device=cuda_device)
    minima = fr.block_minima_plain(costs)
    g32, pw = fr._f32(gamma), fr._tsallis_pw(r)
    fr.reset_launch_counts()
    rows, rho = fr.tsallis_block_rows(U, costs, minima, gamma, r, K_valid)
    given, _ = fr.tsallis_block_rows(U, costs, costs.min().reshape(1), gamma, r, K_valid)
    torch.cuda.synchronize()
    assert {k: v for k, v in fr.launch_counts.items() if v} == {"tsallis_reduce_tiled_kernel": 2}
    with smoke.swapped(libs):
        one_rows, one_rho = fr.tsallis_block_rows(U, costs, minima, gamma, r, K_valid)
    prho = torch.amin(minima)
    prows = fr.tsallis_rows_plain(U, costs, prho, g32, pw, K_valid)
    torch.cuda.synchronize()
    assert fr.launch_counts["tsallis_reduce_kernel"] == 1
    assert torch.equal(rho, prho) and torch.equal(one_rho, prho)
    assert torch.equal(rows, prows) and torch.equal(one_rows, prows)
    assert torch.equal(given, fr.tsallis_rows_plain(U, costs, costs.min(), g32, pw, K_valid))


@pytest.mark.cuda
def test_tsallis_tiled_keeps_a_nan_rho(cuda_device, one_thread_solve_tsallis):
    """A NaN cost gives a NaN rho and zero weights in both builds."""
    smoke, libs = one_thread_solve_tsallis
    g = torch.Generator(device=cuda_device).manual_seed(5)
    U = torch.randn((8192, 100, 2), generator=g, device=cuda_device)
    costs = 1.0 + torch.rand((8192,), generator=g, device=cuda_device)
    costs[4321] = float("nan")
    minima = fr.block_minima_plain(costs)
    rows, rho = fr.tsallis_block_rows(U, costs, minima, 10.0, 2.0)
    with smoke.swapped(libs):
        one_rows, one_rho = fr.tsallis_block_rows(U, costs, minima, 10.0, 2.0)
    torch.cuda.synchronize()
    assert bool(torch.isnan(rho)) and bool(torch.isnan(one_rho))
    assert float(rows.abs().sum()) == 0.0 and torch.equal(rows, one_rows)


# --- B1's warp form for the network pairs (csrc/rollout_kernel.cuh
# rollout_costs_warp_kernel, then the carry or minima pass),
# against its plain version and the one-thread build (chip_smoke.py's
# -DMPPI_SOLVE_ONE_THREAD -DMPPI_ROLLOUT_ONE_THREAD over the network pairs'
# sources and rollout_x0.cu) ---
@pytest.fixture(scope="module")
def one_thread_rollout():
    """The network pairs' B1 (one x0 and one per sample) one thread a
    sample, built beside the port's, and chip_smoke (its ``swapped`` points
    the wrappers at them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke

    libs = {}
    chip_smoke.build_variants((
        (libs, ("MPPI_SOLVE_ONE_THREAD", "MPPI_ROLLOUT_ONE_THREAD"), "rollout_one_thread_test",
         tuple(_build.pair_entry(p, "rollout")[0] for p in WARP_PAIRS) + ("rollout_x0",)),))
    return chip_smoke, libs


# (pair, map, K, T, x0 rows): the paths' shapes (AutoRally 1920 x 150 on both
# bench maps, racer steering 1920 x 100, racer uncertainty 1920 x 150), the
# partly-crashing map, K = 1900 and 1901 (the last block of warps and of 64
# samples partly empty), T = 31 (one partial chunk); AutoRally from one x0
# per sample with ARRobustCost: RMPPI stage 1's 9 candidates x 256 samples
# (each candidate's row repeated) and 2304 rows of their own, on the bench
# map and the partly-crashing one
ROLLOUT_WARP_CASES = {
    "ar 128 1920x150": ("ar_nn", "128", 1920, 150, None),
    "ar 1024 1920x150": ("ar_nn", "1024", 1920, 150, None),
    "ar partial 1920x150": ("ar_nn", "partial", 1920, 150, None),
    "ar partial 1900x150": ("ar_nn", "partial", 1900, 150, None),
    "ar partial 1901x31": ("ar_nn", "partial", 1901, 31, None),
    "steering 1920x100": ("racer_steering_ar", None, 1920, 100, None),
    "steering 1900x100": ("racer_steering_ar", None, 1900, 100, None),
    "steering 1901x31": ("racer_steering_ar", None, 1901, 31, None),
    "unc 1920x150": ("racer_unc_ar", None, 1920, 150, None),
    "unc 1901x31": ("racer_unc_ar", None, 1901, 31, None),
    "x0 128 9x256x150": ("ar_nn", "128", 2304, 150, 9),
    "x0 partial 2304x150": ("ar_nn", "partial", 2304, 150, 2304),
    "x0 partial 2300x31": ("ar_nn", "partial", 2300, 31, 2300),
}
# mode: (epilogue, with LR)
ROLLOUT_WARP_MODES = {"costs": (fr.EPI_NONE, False), "costs+lr": (fr.EPI_NONE, True),
                      "epilogue": (fr.EPI_EXP, False), "epilogue+lr": (fr.EPI_EXP, True),
                      "tsallis": (fr.EPI_MIN, False), "tsallis+lr": (fr.EPI_MIN, True)}


def _rollout_warp_inputs(case, dev):
    """(dynamics, cost, x0, U, LR tables) of a case: U clamped to the
    model's range, a 10 % pure-noise tail."""
    pair, map_kind, K, T_, x0_rows = ROLLOUT_WARP_CASES[case]
    dyn, cost, x0, std = _solve_warp_parts(pair, map_kind, dev)
    g = torch.Generator(device=dev).manual_seed(K + T_ + 23)
    if x0_rows is not None:
        cost = ARRobustCost(costmap=cost.costmap, device=dev)
        x0 = (x0 + 0.1 * torch.randn((x0_rows, x0.numel()), generator=g, device=dev))
        x0 = x0.repeat_interleave(K // x0_rows, dim=0).contiguous()
    mean = 0.3 * torch.randn((T_, C), generator=g, device=dev)
    sigma = torch.tensor([std], device=dev).expand(T_, C).contiguous()
    U = (mean + sigma * torch.randn((K, T_, C), generator=g, device=dev)).clamp(-0.9, 0.9)
    thresh = float((np.float32(1) - np.float32(0.1)) * np.float32(K))
    lr = (mean, sigma, torch.tensor([0.5, 1.0], device=dev), LAM, ALPHA, thresh)
    return dyn, cost, x0, U.contiguous(), lr


def _rollout_epilogue(dyn, cost, x0, U, lr, epilogue):
    """B1 through its public entry in the ``epilogue`` mode, combined form:
    (costs, crash, out)."""
    if epilogue == fr.EPI_EXP:
        return fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lr, split_cost=False)
    if epilogue == fr.EPI_MIN:
        return fr.rollout_block_minima(dyn, cost, x0, U, DT, lr, split_cost=False)
    return (*fr.fused_rollout_costs(dyn, cost, x0, U, DT, lr, split_cost=False), None)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", list(ROLLOUT_WARP_MODES))
@pytest.mark.parametrize("case", list(ROLLOUT_WARP_CASES))
def test_rollout_warp_matches_plain_and_the_one_thread_build(cuda_device, one_thread_rollout,
                                                             case, mode):
    """B1's warp form against its plain version and the one-thread build:
    costs, crash flags, the carry rows (in write_block_carry's order) and the
    block minima bit for bit; one launch of rollout_costs_warp_kernel and,
    with an epilogue, one of its pass."""
    smoke, libs = one_thread_rollout
    epilogue, with_lr = ROLLOUT_WARP_MODES[mode]
    dyn, cost, x0, U, lr = _rollout_warp_inputs(case, cuda_device)
    lr = lr if with_lr else None
    fr.reset_launch_counts()
    got = _rollout_epilogue(dyn, cost, x0, U, lr, epilogue)
    torch.cuda.synchronize()
    want_launches = {"rollout_costs_warp_kernel": 1}
    if epilogue != fr.EPI_NONE:
        want_launches["block_carry_tiled_kernel" if epilogue == fr.EPI_EXP
                      else "block_min_warp_kernel"] = 1
    assert {k: v for k, v in fr.launch_counts.items() if v} == want_launches
    pair = ROLLOUT_WARP_CASES[case][0]
    prefix = "rollout_costs_x0_" if x0.dim() == 2 else "rollout_costs_"
    assert fr.entry_counts == {prefix + pair: 1}
    with smoke.swapped(libs):
        one = _rollout_epilogue(dyn, cost, x0, U, lr, epilogue)
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_kernel"] == 1
    assert torch.isfinite(pc).all()
    out = (None if epilogue == fr.EPI_NONE
           else fr.block_carries_ordered(pc, U, fr._f32(LAM)) if epilogue == fr.EPI_EXP
           else fr.block_minima_plain(pc))
    for name, a, b, c in zip(("costs", "crash", "out"), got, one, (pc, pcrash, out)):
        if c is None:
            continue
        assert torch.equal(a, c), name
        assert torch.equal(b, c), name
    if epilogue == fr.EPI_EXP:
        _close(got[2], fr.block_carries_plain(pc, U, LAM), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_rollout_warp_crash_populations(cuda_device):
    """Over one partial chunk the partly-crashing map crashes some of
    AutoRally's samples, from one x0 and from one x0 per sample, so the
    sticky crash flags above are worth comparing; the bench map crashes
    every sample."""
    for case, mixed in (("ar partial 1901x31", True), ("x0 partial 2300x31", True),
                        ("ar 128 1920x150", False)):
        dyn, cost, x0, U, lr = _rollout_warp_inputs(case, cuda_device)
        _, crash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lr, split_cost=False)
        n = int(crash.sum())
        assert (0 < n < U.shape[0]) if mixed else n == U.shape[0], case


@pytest.mark.cuda
def test_rollout_warp_keeps_a_nan_cost_in_the_minima(cuda_device, one_thread_rollout):
    """A NaN in U gives its sample a NaN cost, and the minima pass keeps it
    NaN in that block, as the one-thread kernel and the plain version do."""
    smoke, libs = one_thread_rollout
    dyn, cost, x0, U, lr = _rollout_warp_inputs("ar partial 1901x31", cuda_device)
    U[100, 3, 0] = float("nan")
    got = fr.rollout_block_minima(dyn, cost, x0, U, DT, lr, split_cost=False)
    with smoke.swapped(libs):
        one = fr.rollout_block_minima(dyn, cost, x0, U, DT, lr, split_cost=False)
    pc, _ = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    torch.cuda.synchronize()
    want = fr.block_minima_plain(pc)
    assert bool(torch.isnan(want[1])) and bool(torch.isnan(got[2][1]))
    for a in (got[2], one[2]):
        assert torch.equal(a.isnan(), want.isnan())
        assert torch.equal(a.nan_to_num(), want.nan_to_num())


@pytest.mark.cuda
def test_rollout_warp_builds_report_their_form(cuda_device, one_thread_rollout):
    """The network pairs' B1 entries (and AutoRally's per-sample-x0 entry)
    report the warp form in the port's build and the one-thread kernel with
    -DMPPI_ROLLOUT_ONE_THREAD, beside their B3 in its one-thread form."""
    smoke, libs = one_thread_rollout
    entries = [_build.pair_entry(p, "rollout") for p in WARP_PAIRS]
    entries.append(_build.pair_entry("ar_nn", "rollout_x0"))
    for entry in entries:
        assert fr.form_kernel_name("rollout_costs", entry) == "rollout_costs_warp_kernel"
        with smoke.swapped(libs):
            assert fr.form_kernel_name("rollout_costs", entry) == "rollout_costs_kernel"
    for pair in WARP_PAIRS:
        with smoke.swapped(libs):
            assert fr.form_kernel_name("fused_solve", _build.pair_entry(pair, "solve")) == (
                "fused_solve_kernel")


# --- the staged form of the split dynamics passes (csrc/split_staged.cuh:
# split_dynamics_staged_kernel, split_solve_dynamics_staged_kernel) for the
# pairs without a network step, against their plain versions and their
# one-thread build (chip_smoke.py's -DMPPI_SPLIT_ONE_THREAD) ---
SPLIT_STAGED_PAIRS = ["di_circle", "di_quadratic", "cartpole", "quadrotor_quadratic",
                      "dubins_quadratic", "bicycle_ar"]
# (K, T) of each pair's loops and their ragged shapes, and a small block
SPLIT_STAGED_SHAPES = {"path": (8192, 100), "ragged": (8000, 100), "small": (65, 33)}
SPLIT_STAGED_BICYCLE = {"path": (1920, 100), "ragged": (1901, 100), "small": (65, 33)}


@pytest.fixture(scope="module")
def one_thread_split_staged():
    """The one-thread split passes of the staged pairs' split sources,
    built beside the port's, and chip_smoke (its ``swapped`` points the
    wrappers at them)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke

    libs = {}
    sources = tuple(sorted({_build.pair_entry(p, k)[0] for p in SPLIT_STAGED_PAIRS + ["di_robust"]
                            for k in ("split_solve_dynamics", "split_dynamics_x0")
                            if _build.pair_entry(p, k) is not None}))
    chip_smoke.build_variants(
        ((libs, ("MPPI_SPLIT_ONE_THREAD",), "split_one_thread_test", sources),))
    return chip_smoke, libs


def _split_staged_shape(pair, shape):
    return (SPLIT_STAGED_BICYCLE if pair == "bicycle_ar" else SPLIT_STAGED_SHAPES)[shape]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "nln"])
@pytest.mark.parametrize("shape", ["path", "ragged", "small"])
@pytest.mark.parametrize("pair", SPLIT_STAGED_PAIRS)
def test_split_staged_solve_pass_matches_plain_and_the_one_thread_build(
        cuda_device, one_thread_split_staged, pair, shape, kind):
    """B3's split dynamics pass in its staged form: U, Y and the LR sums bit
    for bit against the plain version and the one-thread build, with a
    pure-noise tail and stride 2; one launch of
    split_solve_dynamics_staged_kernel."""
    smoke, libs = one_thread_split_staged
    K_, T_ = _split_staged_shape(pair, shape)
    dyn, cost, x0, std, offset = _pair_parts(pair, cuda_device)
    Cp = dyn.CONTROL_DIM
    samp = _pair_sampler(kind, std, cuda_device, T_)
    g = torch.Generator(device=cuda_device).manual_seed(K_ + T_)
    mean = 0.2 * torch.randn((T_, Cp), generator=g, device=cuda_device)
    mean[:, -1] += offset
    seed = torch.tensor(K_ + 31, dtype=torch.int32, device=cuda_device)
    args = (dyn, cost, samp, fr.noise_kind(samp), x0, mean, seed, DT, K_, 0, 2, None)
    fr.reset_launch_counts()
    got = fused_solve.split_solve_dynamics_cuda(*args)
    torch.cuda.synchronize()
    assert fr.launch_counts["split_solve_dynamics_staged_kernel"] == 1
    with smoke.swapped(libs):
        one = fused_solve.split_solve_dynamics_cuda(*args)
    torch.cuda.synchronize()
    assert fr.launch_counts["split_solve_dynamics_kernel"] == 1
    pU, plr = fused_solve._samples_plain(dyn, samp, mean, seed, K_, 0, 2, None)
    want = (pU, fr.split_outputs_plain(dyn, x0, pU, DT).permute(1, 2, 0), plr)
    torch.cuda.synchronize()
    for name, a, b, w in zip(("U", "Y", "LR sums"), got, one, want):
        assert torch.isfinite(w).all(), name
        assert torch.equal(a, w), name
        assert torch.equal(b, w), name


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["path", "ragged", "small"])
@pytest.mark.parametrize("pair", SPLIT_STAGED_PAIRS[:-1])
def test_split_staged_dynamics_pass_matches_plain_and_the_one_thread_build(
        cuda_device, one_thread_split_staged, pair, shape):
    """B1's split dynamics pass in its staged form: Y bit for bit against
    the plain version and the one-thread build; one launch of
    split_dynamics_staged_kernel."""
    smoke, libs = one_thread_split_staged
    K_, T_ = _split_staged_shape(pair, shape)
    dyn, cost, x0, std, offset = _pair_parts(pair, cuda_device)
    Cp = dyn.CONTROL_DIM
    g = torch.Generator(device=cuda_device).manual_seed(K_ + T_ + 1)
    mean = 0.2 * torch.randn((T_, Cp), generator=g, device=cuda_device)
    mean[:, -1] += offset
    U = mean + torch.tensor(std, device=cuda_device) * torch.randn(
        (K_, T_, Cp), generator=g, device=cuda_device)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    fr.reset_launch_counts()
    Y = fr.split_dynamics_cuda(dyn, cost, x0, U, DT)
    torch.cuda.synchronize()
    assert fr.launch_counts["split_dynamics_staged_kernel"] == 1
    with smoke.swapped(libs):
        one = fr.split_dynamics_cuda(dyn, cost, x0, U, DT)
    pY = fr.split_outputs_plain(dyn, x0, U, DT).permute(1, 2, 0)
    torch.cuda.synchronize()
    assert fr.launch_counts["split_dynamics_kernel"] == 1
    assert torch.isfinite(pY).all()
    assert torch.equal(Y, pY) and torch.equal(one, pY)


@pytest.mark.cuda
@pytest.mark.parametrize("n_cand,s_per,T_", [(9, 64, 48), (9, 256, 50), (3, 23, 31)])
def test_split_staged_x0_pass_matches_plain_and_the_one_thread_build(
        cuda_device, one_thread_split_staged, n_cand, s_per, T_):
    """B1's split dynamics pass from one x0 per sample (the DI robust cost's
    RMPPI candidates) in its staged form: Y bit for bit against the plain
    version and the one-thread build."""
    smoke, libs = one_thread_split_staged
    dyn, cost, x0, std, _ = _pair_parts("di_robust", cuda_device)
    dx = torch.tensor([0.4, 0.2, 0.3, -0.4], device=cuda_device)
    w = torch.linspace(0.0, 1.0, n_cand, device=cuda_device)[:, None]
    X0 = (x0[None] + w * dx[None]).repeat_interleave(s_per, dim=0).contiguous()
    K_ = X0.shape[0]
    g = torch.Generator(device=cuda_device).manual_seed(K_ + T_)
    U = (torch.tensor(std, device=cuda_device)
         * torch.randn((K_, T_, C), generator=g, device=cuda_device)).contiguous()
    fr.reset_launch_counts()
    Y = fr.split_dynamics_cuda(dyn, cost, X0, U, DT)
    torch.cuda.synchronize()
    assert fr.launch_counts["split_dynamics_staged_kernel"] == 1
    with smoke.swapped(libs):
        one = fr.split_dynamics_cuda(dyn, cost, X0, U, DT)
    pY = fr.split_outputs_plain(dyn, X0, U, DT).permute(1, 2, 0)
    torch.cuda.synchronize()
    assert torch.equal(Y, pY) and torch.equal(one, pY)


@pytest.mark.cuda
def test_split_staged_builds_report_their_form(cuda_device, one_thread_split_staged):
    """Every analytic pair's split dynamics entries report the staged form
    (2) in the port's build and the one-thread kernel (0) with
    -DMPPI_SPLIT_ONE_THREAD; the bicycle's B1 pass reports the lane-group
    form (5), the network pairs' passes the warp form (1)."""
    smoke, libs = one_thread_split_staged
    entries = [(p, k) for p in SPLIT_STAGED_PAIRS for k in ("split_dynamics",
                                                            "split_solve_dynamics")]
    entries.append(("di_robust", "split_dynamics_x0"))
    for pair, kind in entries:
        entry = _build.pair_entry(pair, kind)
        base = "split_solve_dynamics" if kind == "split_solve_dynamics" else "split_dynamics"
        lanes = pair == "bicycle_ar" and kind == "split_dynamics"
        want = fr._form(fr._lib(entry[0]), entry[1])
        assert want == (5 if lanes else 2), (pair, kind)
        assert fr.form_kernel_name(base, entry) == base + (
            "_lanes_kernel" if lanes else "_staged_kernel")
        with smoke.swapped(libs):
            assert fr.form_kernel_name(base, entry) == base + "_kernel", (pair, kind)
    for pair in WARP_PAIRS:
        for kind in ("split_dynamics", "split_solve_dynamics"):
            entry = _build.pair_entry(pair, kind)
            assert fr._form(fr._lib(entry[0]), entry[1]) == 1, (pair, kind)


# --- the passes after the warp forms (csrc/block_pass.cuh:
# block_carry_tiled_kernel, block_min_warp_kernel, each launched as the
# programmatic dependent of the kernel before it) and B6 over a warp
# (csrc/riccati_kernels.cuh riccati_backward_warp_kernel), against their
# plain versions and the earlier forms' builds (chip_smoke.py's
# -DMPPI_PASS_UNSTAGED over the merge's library, which launches the passes
# alone, and -DMPPI_BACKWARD_ONE_THREAD over riccati.cu) ---
@pytest.fixture(scope="module")
def earlier_passes():
    """The merge's library with the earlier passes and riccati.cu with the
    one-thread B6 (and ladder), built beside the port's, and chip_smoke."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke

    libs, ric = {}, {}
    chip_smoke.build_variants((
        (libs, ("MPPI_PASS_UNSTAGED",), "pass_unstaged_test", ("flash_combine",)),
        (ric, ("MPPI_LADDER_ONE_THREAD", "MPPI_BACKWARD_ONE_THREAD"), "backward_one_thread_test",
         ("riccati",))))
    return chip_smoke, libs, ric["riccati"]


# (K, T*C, special): the paths' shapes (AutoRally and racer uncertainty 1920 x
# 300, racer steering 1920 x 200), the ragged loops' (1901 and 65 at T = 31:
# rows not on 16 bytes), the smallest, a NaN and a +inf cost, X off 16 bytes
# with T*C a multiple of 4, and a row of more tiles than a grid has rows
CARRY_PASS_CASES = {
    "1920x300": (1920, 300, ""), "1920x200": (1920, 200, ""), "1901x62": (1901, 62, ""),
    "65x62": (65, 62, ""), "64x2": (64, 2, ""), "1x300": (1, 300, ""),
    "1920x300 nan": (1920, 300, "nan"), "1901x300 inf": (1901, 300, "inf"),
    "1920x300 misaligned": (1920, 300, "misaligned"),
    "2x2097184 tiles past the grid": (2, 2097184, ""),
}


def _pass_inputs(K, TC, special, dev):
    g = torch.Generator(device=dev).manual_seed(K + TC)
    costs = 50.0 * torch.rand((K,), generator=g, device=dev) + 10.0
    if special == "nan":
        costs[K // 2] = float("nan")
    if special == "inf":
        costs[K - 1] = float("inf")
    X = torch.randn((K * TC + 1,), generator=g, device=dev)
    X = X[1:] if special == "misaligned" else X[:-1]
    return costs, X.view(K, TC // 2, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("lam", [LAM_AR, 0.3])
@pytest.mark.parametrize("case", list(CARRY_PASS_CASES))
def test_block_pass_carry_matches_plain_and_the_unstaged_build(cuda_device, earlier_passes,
                                                              case, lam):
    """The tiled carry pass against block_carries_ordered and the earlier
    block_carry_kernel, bit for bit (NaN where they are NaN); one launch of
    each."""
    smoke, libs, _ = earlier_passes
    K, TC, special = CARRY_PASS_CASES[case]
    costs, X = _pass_inputs(K, TC, special, cuda_device)
    want = fr.block_carries_ordered(costs, X, fr._f32(lam))
    fr.reset_launch_counts()
    got = [fr._block_carries(costs, X, lam)]
    torch.cuda.synchronize()
    assert {k: v for k, v in fr.launch_counts.items() if v} == {"block_carry_tiled_kernel": 1}
    with smoke.swapped(libs):
        assert fr.pass_kernel_name("block_carry") == "block_carry_kernel"
        got.append(fr._block_carries(costs, X, lam))
    torch.cuda.synchronize()
    assert fr.launch_counts["block_carry_kernel"] == 1
    for i, a in enumerate(got):
        assert _same(a, want), i
    assert bool(want.isnan().any()) == (special == "nan")


@pytest.mark.cuda
@pytest.mark.parametrize("special", ["", "nan"])
@pytest.mark.parametrize("K", [1920, 1901, 8192, 65, 64, 1])
def test_block_pass_min_matches_plain_and_the_unstaged_build(cuda_device, earlier_passes, K,
                                                            special):
    smoke, libs, _ = earlier_passes
    costs, _ = _pass_inputs(K, 2, special, cuda_device)
    want = fr.block_minima_plain(costs)
    fr.reset_launch_counts()
    got = fr._block_minima(costs)
    with smoke.swapped(libs):
        one = fr._block_minima(costs)
    torch.cuda.synchronize()
    assert {k: v for k, v in fr.launch_counts.items() if v} == {
        "block_min_warp_kernel": 1, "block_min_kernel": 1}
    assert _same(got, want) and _same(one, want)
    assert bool(got.isnan().any()) == (special == "nan")


@pytest.mark.cuda
@pytest.mark.parametrize("S_,C_,T_", [(4, 2, 50), (4, 2, 48), (4, 1, 100), (7, 2, 150),
                                      (7, 2, 1024), (4, 1, 1024), (7, 2, 31), (4, 2, 2)])
def test_riccati_backward_warp_matches_plain_and_the_one_thread_build(cuda_device,
                                                                      earlier_passes, S_, C_,
                                                                      T_):
    """B6 over a warp against riccati_backward_plain and the one-thread
    kernel bit for bit: the gains and the feedforward terms, at the
    linearisations' sizes and at the longest horizon the kernels take
    (T = 1024: 64 KB of gains in shared memory at (7, 2))."""
    smoke, _, ric = earlier_passes
    rng = np.random.default_rng(S_ * 100 + C_ * 10 + T_)
    f = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda_device)
    back = (f(np.eye(S_) + 0.05 * rng.normal(size=(T_, S_, S_))),
            f(0.1 * rng.normal(size=(T_, S_, C_))), f(rng.normal(size=(T_, S_))),
            f(rng.normal(size=(T_, C_))), f(np.diag(rng.uniform(0.5, 2.0, S_))),
            f(np.diag(rng.uniform(0.5, 2.0, C_))), f(3 * np.eye(S_) + 0.1), f(rng.normal(size=S_)))
    riccati.reset_launch_counts()
    kK, kk = riccati.riccati_backward(*back, DT)
    with smoke.swapped(ladder=ric):
        assert riccati.backward_kernel_name() == "riccati_backward_kernel"
        oK, ok = riccati.riccati_backward(*back, DT)
    pK, pk = riccati.riccati_backward_plain(*back[:4], back[4] * DT, back[5] * DT, back[6],
                                            back[7], DT, 1e-6)
    torch.cuda.synchronize()
    assert {k: v for k, v in riccati.launch_counts.items() if v} == {
        "riccati_backward_warp_kernel": 1, "riccati_backward_kernel": 1}
    assert torch.isfinite(pK).all() and pK.abs().max() > 0
    for a, b, c in ((kK, oK, pK), (kk, ok, pk)):
        assert torch.equal(a, c) and torch.equal(b, c)


# --- the rest of the racer family: B1, B3 and B4 of RACER Dubins, its
# elevation model, RacerSuspension, the bicycle on its elevation map and the
# suspension model with its steering LSTM, and the racer_unc_ar entries on an
# elevation map ---
FAMILY_STAGED_PAIRS = ["racer_dubins_ar", "racer_elevation_ar", "racer_suspension_ar",
                       "bicycle_elevation_ar"]
FAMILY_WARP_PAIRS = ["racer_elev_susp_ar"]
FAMILY = FAMILY_STAGED_PAIRS + FAMILY_WARP_PAIRS + ["racer_unc_map"]


def _family_parts(name, dev, seed=0):
    """(dynamics, cost, x0, its C entry suffix) of a family configuration on
    a 64^2 elevation map (0.3 normal heights) and the 64^2 track map of the
    racer cases (a hot block ahead), LSTMs at scale 0.5 with a warm (h, c)."""
    rng = np.random.default_rng(seed)
    elev = MapTexture2D((0.3 * rng.normal(size=(64, 64))).astype("f"),
                        origin=(-8.0, -8.0, 0.0), resolution=0.25, device=dev)
    track = (0.15 * np.abs(rng.normal(size=(64, 64)))).astype("f")
    track[34:, 46:] = 3.0
    tex = MapTexture2D(track, origin=(-3.2, -3.2, 0.0), resolution=0.1, device=dev)
    indices = RACER_INDICES
    S = {"racer_dubins_ar": 7, "racer_elevation_ar": 9, "bicycle_elevation_ar": 22,
         "racer_elev_susp_ar": 23, "racer_unc_map": 26}.get(name, 14)
    x0 = torch.zeros(S, device=dev)
    x0[0], x0[1] = 3.0, 0.2
    if name == "racer_dubins_ar":
        dyn = RacerDubinsDynamics.create(device=dev)
    elif name == "racer_elevation_ar":
        dyn = RacerDubinsElevationDynamics.create(elevation_map=elev, device=dev)
    elif name == "racer_suspension_ar":
        dyn, indices = RacerSuspensionDynamics.create(elevation_map=elev, device=dev), (
            0, 1, 5, 6, 3, 4)
        x0 = dyn.get_zero_state()
        x0[7] = 3.0
    elif name == "bicycle_elevation_ar":
        dyn = BicycleSlipParametricElevation.create(elevation_map=elev, K_x=0.3, K_y=0.2,
                                                    device=dev)
        x0 = torch.zeros(S, device=dev)
        x0[2], x0[5], x0[12:16] = 0.2, 3.0, 0.05
    else:
        warm = {n: 0.3 * rng.normal(size=16) for n in RacerDubinsElevationLSTMUncertainty.WARM}
        nets = [LSTM.create(i, 16, [16 + i, 16, o], seed=seed + j, scale=0.5)
                for j, (i, o) in enumerate(((4, 1), (11, 2), (12, 5)))]
        if name == "racer_elev_susp_ar":
            dyn = RacerDubinsElevationSuspension(nets[0], elev, warm_hidden=warm["warm_hidden"],
                                                 warm_cell=warm["warm_cell"], device=dev)
        else:
            dyn = RacerDubinsElevationLSTMUncertainty(*nets, elevation_map=elev, warm=warm,
                                                      device=dev)
    cost = ARStandardCost(costmap=tex, output_indices=indices, device=dev)
    return dyn, cost, x0, "racer_unc_ar" if name == "racer_unc_map" else name


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("name", FAMILY)
@pytest.mark.parametrize("mode", ["costs", "costs+lr", "epilogue+lr", "tsallis+lr"])
def test_family_rollout_kernel_matches_plain(cuda_device, K, name, mode):
    dyn, cost, x0, pair = _family_parts(name, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(K)
    mean = 0.3 * torch.randn((T, C), generator=g, device=cuda_device)
    sigma = torch.tensor([[0.3, 0.5]], device=cuda_device).expand(T, C).contiguous()
    U = (mean + sigma * torch.randn((K, T, C), generator=g, device=cuda_device)).clamp(-1, 1)
    U = U.contiguous()
    lr = ((mean, sigma, torch.tensor([0.5, 1.0], device=cuda_device), LAM, ALPHA, 0.9 * K)
          if mode.endswith("+lr") else None)
    fr.reset_launch_counts()
    if mode.startswith("costs"):
        kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lr)
    elif mode.startswith("epilogue"):
        kc, kcrash, kout = fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lr)
    else:
        kc, kcrash, kout = fr.rollout_block_minima(dyn, cost, x0, U, DT, lr)
    torch.cuda.synchronize()
    assert fr.entry_counts == {f"rollout_costs_{pair}": 1}
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    if mode.startswith("epilogue"):
        _close(kout, fr.block_carries_plain(pc, U, LAM), rtol=1e-5, atol=1e-5)
    elif mode.startswith("tsallis"):
        assert torch.equal(kout, fr.block_minima_plain(pc))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("name", FAMILY)
@pytest.mark.parametrize("sampler", ["gaussian", "nln"])
def test_family_fused_solve_kernel_matches_plain(cuda_device, K, name, sampler):
    dyn, cost, x0, pair = _family_parts(name, cuda_device, seed=1)
    g = torch.Generator(device=cuda_device).manual_seed(K + 1)
    mean = 0.3 * torch.randn((T, C), generator=g, device=cuda_device)
    cls = NLNDistribution if sampler == "nln" else GaussianDistribution
    samp = cls.create(std_dev=[0.3, 0.5], control_cost_coeff=[0.5, 1.0],
                      pure_noise_percentage=P_PURE, device=cuda_device)
    seed = torch.tensor(K, dtype=torch.int32, device=cuda_device)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    fr.reset_launch_counts()
    kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, optimization_stride=2)
    torch.cuda.synchronize()
    assert fr.entry_counts == {f"fused_solve_{pair}": 1}
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(*args, optimization_stride=2)
    _close(kU, pU, rtol=0, atol=0)
    _close(kc, pc, rtol=0, atol=0)
    assert torch.equal(kcrash, pcrash)
    _close(kcarry, pcarry, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [256, 300])
@pytest.mark.parametrize("name", FAMILY)
@pytest.mark.parametrize("sampler", ["gaussian", "nln", "smooth", "smooth_epilogue"])
def test_family_sampling_kernel_matches_plain(cuda_device, K, name, sampler):
    dyn, cost, x0, pair = _family_parts(name, cuda_device, seed=2)
    g = torch.Generator(device=cuda_device).manual_seed(K + 2)
    mean = 0.3 * torch.randn((T, C), generator=g, device=cuda_device)
    kw = dict(std_dev=[0.3, 0.5], control_cost_coeff=[0.5, 1.0], pure_noise_percentage=P_PURE,
              device=cuda_device)
    if sampler.startswith("smooth"):
        samp = SmoothMPPIDistribution.create(num_timesteps=T, dt=0.05, **kw)
        state = 0.3 * torch.randn((T, C), generator=g, device=cuda_device)
    else:
        samp = (NLNDistribution if sampler == "nln" else GaussianDistribution).create(**kw)
        state = None
    seed = torch.tensor(K, dtype=torch.int32, device=cuda_device)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K)
    epilogue = sampler == "smooth_epilogue"
    fr.reset_launch_counts()
    kout = fr.fused_sample_rollout_costs(*args, optimization_stride=2, sampler_state=state,
                                         epilogue=epilogue)
    torch.cuda.synchronize()
    assert fr.entry_counts == {f"fused_sample_rollout_{pair}": 1}
    pc, pcrash, pU, pW = fr.sample_rollout_plain(*args, optimization_stride=2,
                                                 sampler_state=state)
    _close(kout[0], pc, rtol=0, atol=0)
    assert torch.equal(kout[1], pcrash)
    _close(kout[2], pU, rtol=0, atol=0)
    if epilogue:
        pm, pb, pe = fr.flash_combine_plain(fr.block_carries_plain(pc, pW, LAM), T, C, LAM)
        _close(kout[3], pm, rtol=1e-4, atol=1e-5)
        _close(kout[4], pb, rtol=1e-5, atol=0)
        _close(kout[5], pe, rtol=1e-4, atol=0)
    elif pW is not None:
        _close(kout[3], pW, rtol=0, atol=0)


@pytest.mark.cuda
def test_family_normals_map_is_refused_on_the_card(cuda_device):
    """A normals map has no kernel: the wrappers refuse it before any launch
    (KernelIncompatible), so a controller takes its eager path."""
    dyn, cost, x0, _ = _family_parts("bicycle_elevation_ar", cuda_device)
    n = np.zeros((16, 16, 3), np.float32)
    n[..., 2] = 1.0
    dyn.normals_map = MapTexture2D(n, device=cuda_device)
    U = torch.zeros((64, T, C), device=cuda_device)
    fr.reset_launch_counts()
    with pytest.raises(fr.KernelIncompatible, match="normals_map"):
        fr.fused_rollout_costs(dyn, cost, x0, U, DT)
    assert not any(fr.launch_counts.values())
