"""The chunk prologue of B4's warp form, its carry pass and its form
reporting, on the CPU.

B4's warp form (``csrc/sample_warp.cuh``) runs one warp per sample. Nothing
in B4's controls depends on the state, so each chunk of 32 steps starts with
a prologue spread over the lanes: lane j of chunk q makes step 32 q + j (the
Philox draw, NLN's ``z * exp(aux * z2)``, the carve-outs, the clamp and the
step's LR term), step t takes lane t mod 32's values, and lanes with
t >= T make nothing. ``chunk_prologue`` mirrors that index map and the
kernel's float32 operations (``sample_controls``, ``csrc/sample_draw.cuh``)
from ``ops/philox.py``'s Philox, and the tests hold it against the plain B4
(``sample_rollout_plain``) bit for bit: the normals, U, W and the LR terms
(through the costs), for T = 100, 150 and 31 (each ending in a partial
chunk) and the Gaussian, NLN and Smooth-MPPI samplers, with a pure-noise
tail and stride 2, on the double integrator with a deadband. The model does
not enter the index map; the kernels are held against the plain versions on
the card (``tests/test_torch_cuda_kernels.py``, ``-k warp``).

Also: the Smooth epilogue's carry rows (the function of the warp form's
carry pass, ``block_carry_tiled_kernel``) on the CPU path, the C signatures that declare each
B4 and B8 entry's ``<entry>_form``, and the launch counters of the B4 and
B8 wrappers following the form a (stubbed) library reports.
"""

import types

import numpy as np
import pytest
import torch

from mppi_generic_tpu_torch import (
    GaussianDistribution,
    NLNDistribution,
    SmoothMPPIDistribution,
)
from mppi_generic_tpu_torch.costs import ARStandardCost, DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import AutorallyNNDynamics, DoubleIntegratorDynamics
from mppi_generic_tpu_torch.nn import FNN
from mppi_generic_tpu_torch.ops import _build, philox
from mppi_generic_tpu_torch.ops import fused_rollout as fr

LANES = 32
K, DT, LAM, ALPHA, STRIDE, P_PURE, SEED = 40, 0.02, 1.3, 0.1, 2, 0.1, 1234


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _parts(kind, T):
    """(dynamics, cost, sampler, x0, mean, sampler state) on the CPU."""
    dyn = DoubleIntegratorDynamics.create(control_ranges=[[-2.5, 2.5], [-2.0, 2.0]],
                                          control_deadband=[0.05, 0.1], device="cpu")
    kw = dict(std_dev=[0.8, 1.3], control_cost_coeff=[0.5, 1.0],
              pure_noise_percentage=P_PURE, device="cpu")
    if kind == "smooth":
        samp = SmoothMPPIDistribution.create(num_timesteps=T, dt=0.05, **kw)
    else:
        samp = (NLNDistribution if kind == "nln" else GaussianDistribution).create(**kw)
    rng = np.random.default_rng(T)
    mean = torch.from_numpy(rng.normal(scale=0.7, size=(T, 2)).astype(np.float32))
    state = (torch.from_numpy(rng.normal(scale=0.5, size=(T, 2)).astype(np.float32))
             if kind == "smooth" else None)
    x0 = torch.tensor([2.0, 0.05, -0.1, 1.0])
    return dyn, DoubleIntegratorCircleCost(device="cpu"), samp, x0, mean, state


def _clamp(v, cons, c):
    """csrc/mppi_common.cuh clamp_channel of channel c."""
    lo, hi, db, zc = cons[:, c]
    shrunk = v - db * torch.where(v < 0.0, -1.0, 1.0)
    v = torch.where(v.abs() < db, zc, shrunk)
    return torch.minimum(torch.maximum(v, lo), hi)


def chunk_prologue(kind, samp, dyn, mean, state, T):
    """The warp form's prologue, chunk by chunk: lane j of chunk q makes step
    32 q + j for every sample, where that step is < T. Returns (z (n_z, K,
    T, C), U, W or None (K, T, C), lr (K, T)), step t taken from lane
    t mod 32 of chunk t // 32."""
    C = mean.shape[1]
    n_z = 2 if kind == "nln" else 1
    sigma, aux = fr.sample_tables(samp, fr.noise_kind(samp), mean, 0, state)
    cons = fr.constraint_table(dyn)
    coeff = samp.control_cost_coeff
    gain = fr._lr_gain(LAM, ALPHA)
    dt_smooth = fr._f32(getattr(samp, "dt_smooth", 0.0))
    k = torch.arange(K)
    pure = k.to(torch.float32) >= samp.pure_threshold(K)
    z_out = torch.zeros((n_z, K, T, C))
    U = torch.zeros((K, T, C))
    W = torch.zeros((K, T, C)) if kind == "smooth" else None
    lr = torch.zeros((K, T))
    for q in range(-(-T // LANES)):
        t = LANES * q + torch.arange(LANES)
        t = t[t < T]  # the lanes past T make nothing
        p = torch.arange(-(-C // 2))
        words = philox.philox4x32((k[:, None, None], t[None, :, None], p[None, None, :], 0),
                                  (SEED, 0))
        z = []
        for s in range(n_z):
            a, b = philox._box_muller(words[2 * s], words[2 * s + 1])
            z.append(torch.stack([a, b], dim=-1).reshape(K, t.numel(), -1)[..., :C])
        eps = z[0] * torch.exp(aux[t] * z[1]) if kind == "nln" else z[0]
        pin = (k[:, None] == 0) | (t[None, :] < STRIDE)
        u = []
        for c in range(C):
            m = mean[t, c]
            noise = sigma[t, c] * eps[..., c]
            if kind == "smooth":
                w = torch.where(pin, state[t, c], torch.where(
                    pure[:, None], noise, state[t, c] + noise))
                W[:, t, c] = w
                v = m + w * dt_smooth
            else:
                v = torch.where(pin, m, torch.where(pure[:, None], noise, m + noise))
            u.append(_clamp(v, cons, c))
        lr_t = torch.zeros((K, t.numel()))
        for c in range(C):
            mu = torch.where(pure[:, None], 0.0, mean[t, c])
            sg = sigma[t, c]
            lr_t = lr_t + coeff[c] * mu * (mu - 2.0 * u[c]) / (sg * sg)
        for s in range(n_z):
            z_out[s][:, t] = z[s]
        U[:, t] = torch.stack(u, dim=-1)
        lr[:, t] = gain * lr_t
    return z_out, U, W, lr


@pytest.mark.parametrize("kind", ["gaussian", "nln", "smooth"])
@pytest.mark.parametrize("T", [100, 150, 31])
def test_chunk_prologue_equals_the_plain_controls(kind, T):
    dyn, cost, samp, x0, mean, state = _parts(kind, T)
    z, U, W, lr = chunk_prologue(kind, samp, dyn, mean, state, T)
    n_z = 2 if kind == "nln" else 1
    assert torch.equal(z, fr.standard_normals(fr.noise_kind(samp), torch.tensor(SEED), K, T,
                                              2))
    assert z.shape == (n_z, K, T, 2)
    pc, pcrash, pU, pW = fr.sample_rollout_plain(
        dyn, cost, samp, x0, mean, torch.tensor(SEED), DT, LAM, ALPHA, K,
        optimization_stride=STRIDE, sampler_state=state)
    assert torch.equal(U, pU)
    if kind == "smooth":
        assert torch.equal(W, pW)
    else:
        assert pW is None
    # the LR terms through the plain rollout: the same costs to the last bit
    acc, term, crash = fr._rollout_sums(dyn, cost, x0, U, DT, lambda t, u: lr[:, t])
    assert torch.equal(fr.true_div(acc + term, T), pc)
    assert torch.equal(crash, pcrash)
    assert bool(torch.isfinite(pc).all())


def test_smooth_epilogue_carries_are_block_carries_plain():
    """The CPU path of Smooth-MPPI's epilogue merges block_carries_plain
    (costs, W, lambda): the rows of 64 samples that the warp form's carry
    pass writes on the card (a ragged last block here)."""
    T = 31
    dyn, cost, samp, x0, mean, state = _parts("smooth", T)
    Kr = 150
    seed = torch.tensor(SEED)
    args = (dyn, cost, samp, x0, mean, seed, DT, LAM, ALPHA, Kr)
    kc, kcrash, kU, new_dm, base, eta = fr.fused_sample_rollout_costs(
        *args, optimization_stride=STRIDE, sampler_state=state, epilogue=True)
    pc, pcrash, pU, pW = fr.sample_rollout_plain(*args, optimization_stride=STRIDE,
                                                 sampler_state=state)
    carry = fr.block_carries_plain(pc, pW, fr._f32(LAM))
    assert carry.shape == (-(-Kr // fr.BLOCK), 2 + T * 2)
    want = fr.flash_combine_plain(carry, T, 2, fr._f32(LAM))
    for got, w in zip((new_dm, base, eta), want):
        assert torch.equal(got, w)
    assert torch.equal(kc, pc) and torch.equal(kU, pU)


@pytest.mark.parametrize("Kr", [150, 192])
def test_block_carries_ordered_is_block_carries_plain_in_kernel_order(Kr):
    """The carry rows in write_block_carry's order (the card's bit-for-bit
    reference of the carry pass) against the plain rows: the block maxima
    exactly, the sums within float32 rounding."""
    g = torch.Generator().manual_seed(Kr)
    costs = 50.0 * torch.rand(Kr, generator=g)
    X = torch.randn((Kr, 31, 2), generator=g)
    lam = fr._f32(LAM)
    ordered = fr.block_carries_ordered(costs, X, lam)
    plain = fr.block_carries_plain(costs, X, lam)
    assert ordered.shape == plain.shape
    assert torch.equal(ordered[:, 0], plain[:, 0])
    np.testing.assert_allclose(ordered.numpy(), plain.numpy(), rtol=1e-5, atol=1e-6)


# the rest of the racer family: B1, B3 and B4 only so far
FAMILY_PAIRS = {"racer_dubins_ar", "racer_elevation_ar", "racer_suspension_ar",
                "bicycle_elevation_ar", "racer_elev_susp_ar"}


def test_every_sample_and_rmppi_entry_declares_its_form():
    declared = {kind: set() for kind in ("sample", "rmppi")}
    for pair in _build.PAIR_KERNELS:
        for kind in declared:
            entry = _build.pair_entry(pair, kind)
            if entry is not None:
                lib, fn = entry
                assert _build.SIGNATURES[lib][fn + "_form"] == []
                declared[kind].add(pair)
    assert declared["sample"] == set(fr._PAIRS.values())
    # B8 for every pair but the racer LSTMs (JAX refuses a recurrent model)
    # and the rest of the racer family, whose B8 is still to come
    assert declared["rmppi"] == set(fr._PAIRS.values()) - {"racer_steering_ar",
                                                           "racer_unc_ar"} - FAMILY_PAIRS


class _StubLibrary:
    """A kernel library whose entries accept anything and return 0 (the
    launch accepted) and whose ``<entry>_form()`` returns ``form``; the
    merge's ``flash_combine_form()`` and ``block_pass_form()`` return 4,
    the tiled merge and the tiled carry and warp minima passes of the port's
    build, and a ``*_block_size()`` the port's 64 samples."""

    def __init__(self, form):
        self.form = form

    def __getattr__(self, name):
        if name in ("flash_combine_form", "block_pass_form"):
            return lambda: 4
        if name.endswith("_block_size"):
            return lambda: fr.BLOCK
        if name.endswith("_form"):
            return lambda: self.form
        return lambda *args: 0


@pytest.fixture
def stub_form(monkeypatch):
    """Points the wrappers at a stubbed library and lets CPU tensors take
    the launch path; returns a setter of the form the library reports."""
    lib = _StubLibrary(1)
    monkeypatch.setattr(fr, "_lib", lambda name="flash_combine": lib)
    monkeypatch.setattr(fr, "_on_cpu", lambda t: False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))

    def set_form(form):
        lib.form = form

    return set_form


def _autorally():
    dyn = AutorallyNNDynamics(FNN.create([6, 32, 32, 4], seed=0, scale=1.0), device="cpu")
    return dyn, ARStandardCost(device="cpu")


# the kernels each B4 form launches with Smooth-MPPI's epilogue (besides the
# merge): 0 one thread, 1 warp, 2 staged
SAMPLE_FORM_LAUNCHES = {
    0: {"fused_sample_rollout_kernel": 1},
    1: {"fused_sample_rollout_warp_kernel": 1, "block_carry_tiled_kernel": 1},
    2: {"fused_sample_rollout_staged_kernel": 1},
}


@pytest.mark.parametrize("form", [0, 1, 2])
def test_sample_wrapper_counts_the_reported_form(stub_form, form):
    stub_form(form)
    dyn, cost = _autorally()
    T = 8
    samp = SmoothMPPIDistribution.create(std_dev=[0.3, 0.5], num_timesteps=T, dt=0.05,
                                         device="cpu")
    mean = torch.zeros((T, 2))
    fr.reset_launch_counts()
    fr.fused_sample_rollout_costs(dyn, cost, samp, torch.zeros(7), mean,
                                  torch.tensor(3, dtype=torch.int32),
                                  DT, LAM, ALPHA, 100, sampler_state=torch.zeros((T, 2)),
                                  epilogue=True)
    want = {**SAMPLE_FORM_LAUNCHES[form], "flash_combine_tiled_kernel": 1}
    assert {k: v for k, v in fr.launch_counts.items() if v} == want
    assert fr.entry_counts == {"fused_sample_rollout_ar_nn": 1}


@pytest.mark.parametrize("form", [0, 1])
def test_rmppi_wrapper_counts_the_reported_form(stub_form, form):
    stub_form(form)
    dyn, cost = _autorally()
    T = 8
    fr.reset_launch_counts()
    fr.fused_rmppi_rollout(dyn, cost, torch.zeros(7), torch.zeros(7), torch.zeros((100, T, 2)),
                           torch.zeros((T, 2, 7)), torch.ones((T, 2)), torch.ones(2), DT, LAM,
                           ALPHA)
    name = "rmppi_rollout_warp_kernel" if form else "rmppi_rollout_kernel"
    assert {k: v for k, v in fr.launch_counts.items() if v} == {name: 1}
    assert fr.entry_counts == {"rmppi_rollout_ar_nn": 1}
