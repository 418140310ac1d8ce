"""The chunk prologue of B3's warp form and its carry pass, on the CPU.

B3's warp form (``fused_solve_warp_kernel``, ``csrc/sample_warp.cuh``) runs
one warp per sample of the network pairs (AutoRally, the racer LSTMs). Its
controls depend on no state, so each chunk of 32 steps starts with a prologue
spread over the lanes: lane j of chunk q makes step 32 q + j by
``solve_controls`` (``csrc/sample_draw.cuh``: the Philox draw or the injected
normals, NLN's ``z * exp(aux * z2)``, the stride and k = 0 pins, the
pure-noise tail, the clamp, the U row and the step's C LR terms lrc mu (mu -
2 u)); lanes with t >= T make nothing. Step t takes lane t mod 32's controls
and terms by shuffles, and every lane adds the terms one by one, in (t, c)
order, into the LR sum kept apart: J = (acc + terminal + gain lr) / T. The
carry rows (m_b, d_b, num_b) over U stay rows of 64 samples, written after
the warp kernel by the carry pass (``csrc/block_pass.cuh``;
``write_block_carry``'s order, ``fr.block_carries_ordered``).

``solve_prologue`` mirrors that index map and the kernel's float32
operations from ``ops/philox.py``'s Philox, and the tests hold it bit for bit
against the plain B3 (``fused_solve_plain``): the normals, U, the LR terms
(through the costs), the crash flags and the carry rows, for T = 150, 100
and 31 (each ending in a partial chunk), the Gaussian and NLN samplers with a
pure-noise tail and stride 2, and injected normals; on the double
integrator with a deadband and on AutoRally's network. The kernels
themselves are held against the plain versions on the card
(``tests/test_torch_cuda_kernels.py``, ``-k solve_warp``).
"""

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch import GaussianDistribution, NLNDistribution
from mppi_generic_tpu_torch.costs import ARStandardCost, DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.maps import MapTexture2D
from mppi_generic_tpu_torch.models import AutorallyNNDynamics, DoubleIntegratorDynamics
from mppi_generic_tpu_torch.nn import FNN
from mppi_generic_tpu_torch.ops import fused_solve, philox
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from test_torch_sample_warp import _clamp

LANES = 32
K, DT, LAM, ALPHA, STRIDE, P_PURE, SEED = 70, 0.02, 1.3, 0.1, 2, 0.1, 4321


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _parts(pair, kind):
    """(dynamics, cost, sampler, x0) on the CPU."""
    kw = dict(std_dev=[0.8, 1.3], control_cost_coeff=[0.5, 1.0],
              pure_noise_percentage=P_PURE, device="cpu")
    samp = (NLNDistribution if kind == "nln" else GaussianDistribution).create(**kw)
    if pair == "di_circle":
        dyn = DoubleIntegratorDynamics.create(control_ranges=[[-2.5, 2.5], [-2.0, 2.0]],
                                              control_deadband=[0.05, 0.1], device="cpu")
        return dyn, DoubleIntegratorCircleCost(device="cpu"), samp, torch.tensor(
            [2.0, 0.05, -0.1, 1.0])
    rng = np.random.default_rng(0)
    tex = MapTexture2D(np.abs(rng.normal(size=(64, 64))).astype("f"),
                       origin=(-8.0, -8.0, 0.0), resolution=0.25, device="cpu")
    dyn = AutorallyNNDynamics(FNN.create([6, 32, 32, 4], seed=0, scale=1.0), device="cpu")
    x0 = torch.tensor([0.0, 0.0, 0.0, 0.0, 3.0, 0.0, 0.0])
    return dyn, ARStandardCost(costmap=tex, device="cpu"), samp, x0


def _mean(T):
    rng = np.random.default_rng(T)
    return torch.from_numpy(rng.normal(scale=0.7, size=(T, 2)).astype(np.float32))


def solve_prologue(samp, dyn, mean, T, z=None):
    """The warp form's prologue, chunk by chunk: lane j of chunk q makes step
    32 q + j for every sample, where that step is < T, by solve_controls'
    float32 operations. Returns (normals (n_z, K, T, C), U (K, T, C), the
    LR terms (K, T, C))."""
    C = mean.shape[1]
    kind = fr.noise_kind(samp)
    n_z = 2 if kind == fr.NLN else 1
    sigma, aux, lrc = fused_solve._tables(samp, kind, mean, 0)
    cons = fr.constraint_table(dyn)
    k = torch.arange(K)
    pure = k.to(torch.float32) >= samp.pure_threshold(K)
    z_out = torch.full((n_z, K, T, C), float("nan"))
    U = torch.full((K, T, C), float("nan"))
    terms = torch.full((K, T, C), float("nan"))
    for q in range(-(-T // LANES)):
        t = LANES * q + torch.arange(LANES)
        t = t[t < T]  # the lanes past T make nothing
        if z is None:  # draw_eps: Philox keyed by (seed, k, t, channel pair)
            p = torch.arange(-(-C // 2))
            words = philox.philox4x32(
                (k[:, None, None], t[None, :, None], p[None, None, :], 0), (SEED, 0))
            zs = []
            for s in range(n_z):
                a, b = philox._box_muller(words[2 * s], words[2 * s + 1])
                zs.append(torch.stack([a, b], dim=-1).reshape(K, t.numel(), -1)[..., :C])
        else:  # the injected normals, (n_z, K, T, C)
            zs = [z[s][:, t] for s in range(n_z)]
        eps = zs[0] * torch.exp(aux[t] * zs[1]) if kind == fr.NLN else zs[0]
        pin = (k[:, None] == 0) | (t[None, :] < STRIDE)
        for c in range(C):
            m = mean[t, c]
            noise = sigma[t, c] * eps[..., c]
            mu = torch.where(pure[:, None], 0.0, m)
            v = _clamp(torch.where(pin, m, torch.where(pure[:, None], noise, m + noise)),
                       cons, c)
            U[:, t, c] = v
            terms[:, t, c] = lrc[t, c] * mu * (mu - 2.0 * v)
        for s in range(n_z):
            z_out[s][:, t] = zs[s]
    return z_out, U, terms


def warp_solve(dyn, cost, samp, x0, mean, z=None):
    """B3's warp form: (normals, costs, crash, U, carry rows in the kernel's
    order). The LR sum takes the terms shuffled from the lanes step by step,
    channel by channel."""
    T = mean.shape[0]
    normals, U, terms = solve_prologue(samp, dyn, mean, T, z)
    lr = torch.zeros((K,))
    for t in range(T):
        for c in range(mean.shape[1]):
            lr = lr + terms[:, t, c]
    acc, term, crash = fr._rollout_sums(dyn, cost, x0, U, DT)
    costs = fr.true_div(acc + term + fr._lr_gain(LAM, ALPHA) * lr, T)
    return normals, costs, crash, U, fr.block_carries_ordered(costs, U, fr._f32(LAM))


def _check(pair, kind, T, inject):
    dyn, cost, samp, x0 = _parts(pair, kind)
    mean = _mean(T)
    seed = torch.tensor(SEED, dtype=torch.int32)
    n_z = 2 if kind == "nln" else 1
    z = (torch.randn((n_z, K, T, 2), generator=torch.Generator().manual_seed(T))
         if inject else None)
    normals, lc, lcrash, lU, lcarry = warp_solve(dyn, cost, samp, x0, mean, z)
    assert torch.equal(normals, fr.standard_normals(fr.noise_kind(samp), seed, K, T, 2, z))
    pc, pcrash, pU, pcarry = fused_solve.fused_solve_plain(
        dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, K, optimization_stride=STRIDE,
        injected_noise=z)
    assert bool(torch.isfinite(pc).all())
    assert torch.equal(lU, pU)
    assert torch.equal(lc, pc)
    assert torch.equal(lcrash, pcrash)
    assert torch.equal(lcarry, fr.block_carries_ordered(pc, pU, fr._f32(LAM)))
    np.testing.assert_allclose(lcarry.numpy(), pcarry.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["gaussian", "nln"])
@pytest.mark.parametrize("T", [150, 100, 31])
def test_solve_prologue_equals_the_plain_solve(kind, T):
    _check("di_circle", kind, T, inject=False)


@pytest.mark.parametrize("kind", ["gaussian", "nln"])
def test_solve_prologue_takes_injected_normals(kind):
    _check("di_circle", kind, 33, inject=True)


@pytest.mark.parametrize("kind,inject", [("gaussian", False), ("nln", True)])
def test_solve_prologue_on_autorally(kind, inject):
    """The network pair itself (its costs through the plain network step),
    a horizon of one full chunk and a partial one."""
    _check("ar_nn", kind, 40, inject)

