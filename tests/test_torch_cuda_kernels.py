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
    SmoothMPPIDistribution,
    VanillaMPPI,
)
from mppi_generic_tpu_torch.costs import (
    ARRobustCost,
    ARStandardCost,
    CartpoleQuadraticCost,
    DoubleIntegratorCircleCost,
    QuadraticCost,
    QuadrotorMapCost,
    QuadrotorQuadraticCost,
)
from mppi_generic_tpu_torch.feedback.ilqr import _alpha_ladder
from mppi_generic_tpu_torch.maps import MapTexture2D
from mppi_generic_tpu_torch.models import (
    AutorallyNNDynamics,
    BicycleSlipDynamics,
    CartpoleDynamics,
    DoubleIntegratorDynamics,
    DubinsDynamics,
    QuadrotorDynamics,
)
from mppi_generic_tpu_torch.nn import FNN
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import fused_solve, philox, riccati

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
        kc, kcrash, kcarry = fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lr)
    else:
        kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lr)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_kernel"] == 1
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
    kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0s, U, DT)
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
    kc, kcrash, kU, kcarry = fused_solve.fused_solve_carries(*args, **kw)
    torch.cuda.synchronize()
    assert fr.launch_counts["fused_solve_kernel"] == 1
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
    with pytest.raises(NotImplementedError, match="RMPPI"):
        fr.fused_rmppi_rollout(dyn, cost, x0, x0, U, torch.zeros((T, C, 7), device=cuda_device),
                               torch.ones((T, C), device=cuda_device),
                               torch.ones((C,), device=cuda_device), DT, LAM, ALPHA)


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
                           num_timesteps=T, num_rollouts=300, kernel=k,
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
    kc, kcrash, kmin = fr.rollout_block_minima(dyn, cost, x0, U, DT, lr)
    krows, krho = fr.tsallis_block_rows(U, kc, kmin, gamma, r)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_kernel"] == 1
    assert fr.launch_counts["tsallis_reduce_kernel"] == 1
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
        weight_params=(gamma, r))
    torch.cuda.synchronize()
    assert {k: v for k, v in fr.launch_counts.items() if v} == {
        "rollout_costs_kernel": 1, "tsallis_reduce_kernel": 1, "flash_combine_kernel": 1}
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
    assert fr.launch_counts["tsallis_reduce_kernel"] == 1
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
        weight_params=(10.0, 2.0))
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
        kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lr)
    elif mode.startswith("epilogue"):
        kc, kcrash, kout = fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM_AR, lr)
    else:
        kc, kcrash, kout = fr.rollout_block_minima(dyn, cost, x0, U, DT, lr)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_kernel"] == 1
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
            tsallis_gamma=10.0, tsallis_r=2.0)

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
    kc, kcrash = fr.fused_rollout_costs(ctrl.dynamics, ctrl.cost, x, U, ctrl.dt, lr)
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
        kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lr)
    elif mode.startswith("epilogue"):
        kc, kcrash, kout = fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lr)
    else:
        kc, kcrash, kout = fr.rollout_block_minima(dyn, cost, x0, U, DT, lr)
    torch.cuda.synchronize()
    assert fr.launch_counts["rollout_costs_kernel"] == 1
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
    assert fr.launch_counts["fused_solve_kernel"] == 1
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
    # the zoo's rollout entries have no per-sample x0 mode (RMPPI's)
    cdyn, ccost, _, _, _ = _zoo_parts("cartpole", cuda_device)
    with pytest.raises(NotImplementedError, match="per-sample x0"):
        fr.fused_rollout_costs(cdyn, ccost, torch.zeros((64, 4), device=cuda_device),
                               torch.zeros((64, T, 1), device=cuda_device), DT)
