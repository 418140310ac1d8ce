"""The plain versions of the split form's kernels (``csrc/split_kernels.cuh``:
what the wrappers run on CPU tensors) against the JAX package's split mode
of the same kernels (``split_cost=True``, its Pallas kernels in interpret
mode) on the same inputs, for the double integrator with its circle cost
and AutoRally's network with ``ARStandardCost``: B1 in its four modes
(costs, costs + LR, the exp epilogue + LR, Tsallis pass 1 + LR, through
``fused_rollout_costs`` and ``fused_weighted_rollout``) and B3 (Gaussian,
NLN, ``fused_solve_iteration`` with injected normals). Each split plain
version is also held against the port's combined plain version.

Sizes: the double integrator at K=256, T=24 (B1) and at the sizes of
tests/test_injected_noise.py:38 (B3: K=256, T=10); AutoRally at K=128,
T=16 with its network at scale 1 on the 32^2 map of
tests/test_torch_autorally_kernels.py, where part of the samples crash.

Tolerances. JAX's split pass sums blocks of 8 steps, the port's one warp's
lanes, so the sums differ in order: costs rtol 2e-5 / atol 1e-5 for the
double integrator, rtol 3e-5 / atol 3e-3 for AutoRally (its costs reach
1e4; tests/test_pallas_fused.py:309-324 holds JAX's split against its
combined form so); new means, baselines and eta rtol 2e-4 / atol 3e-3 as
there; U rtol 1e-5 / atol 1e-6; crash flags exactly. Against the port's
combined plain version: the same crash flags and U, costs as above.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mppi_generic_tpu.costs import DoubleIntegratorCircleCost as JCircle
from mppi_generic_tpu.models import DoubleIntegratorDynamics as JDI
from mppi_generic_tpu.ops import pallas_rollout
from mppi_generic_tpu.ops.pallas_solve import fused_solve_iteration as jax_solve
from mppi_generic_tpu.sampling import GaussianDistribution as JGaussian
from mppi_generic_tpu.sampling import NLNDistribution as JNLN
from mppi_generic_tpu_torch import convert
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.ops import fused_solve
from test_torch_autorally_kernels import SAMPLER_FIELDS
from test_torch_autorally_kernels import X0 as AR_X0
from test_torch_autorally_kernels import _setup as ar_setup

C = 2
DT, LAM, ALPHA, STRIDE = 0.02, 1.2, 0.1, 2
GAMMA, R_TS = 10.0, 2.0
DI_X0 = np.array([2.0, 0.05, -0.1, 1.0], np.float32)
DI_RANGES = [[-0.9, 0.9], [-0.8, 0.8]]
DYN_FIELDS = ("control_ranges", "control_deadband", "zero_control", "system_noise")
SHAPES = {"di": {"B1": (256, 24), "B3": (256, 10)}, "ar": {"B1": (128, 16), "B3": (128, 16)}}
TOL = {"di": (2e-5, 1e-5), "ar": (3e-5, 3e-3)}


def _params(obj, names):
    return {n: np.asarray(getattr(obj, n)) for n in names}


@functools.lru_cache(maxsize=None)
def _di(kind="gaussian", p=0.0):
    cls = JNLN if kind == "nln" else JGaussian
    std = [0.5, 0.3] if kind == "nln" else [0.7, 0.4]
    jsamp = cls.create(std_dev=std, control_cost_coeff=[0.02, 0.5], pure_noise_percentage=p)
    jdyn, jcost = JDI.create(control_ranges=DI_RANGES), JCircle()
    make = convert.nln_from_params if kind == "nln" else convert.gaussian_from_params
    port = (convert.double_integrator_from_params(_params(jdyn, DYN_FIELDS)),
            convert.circle_cost_from_params(
                _params(jcost, DoubleIntegratorCircleCost.PARAM_NAMES)),
            make(_params(jsamp, SAMPLER_FIELDS)))
    return (jdyn, jcost, jsamp), port


def _pair(pair, kind="gaussian", p=0.0):
    """(JAX parts, port parts, x0) of the pair."""
    if pair == "di":
        return (*_di(kind, p), DI_X0)
    return (*ar_setup("32", kind, p), AR_X0)


def _rollout_inputs(pair, seed=13):
    """Clamped samples around a mean and the LR tables of B1's cases."""
    K, T = SHAPES[pair]["B1"]
    rng = np.random.default_rng(seed)
    mean = (0.2 * rng.normal(size=(T, C))).astype(np.float32)
    sigma = np.tile(np.array([[0.3, 0.5]] if pair == "ar" else [[0.7, 0.4]], np.float32),
                    (T, 1))
    U = np.clip(mean + sigma * rng.normal(size=(K, T, C)), -0.8, 0.8).astype(np.float32)
    coeff = np.array([0.5, 1.0], np.float32)
    thresh = float(np.float32(0.9) * np.float32(K))
    return U, (mean, sigma, coeff, LAM, ALPHA, thresh)


def _close(t, j, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("pair", ["di", "ar"])
@pytest.mark.parametrize("mode", ["costs", "costs+lr", "epilogue+lr", "tsallis+lr"])
def test_b1_split_plain_matches_jax_split(pair, mode):
    (jdyn, jcost, _), (dyn, cost, _), x0 = _pair(pair)
    U, lr = _rollout_inputs(pair)
    K = U.shape[0]
    with_lr = mode.endswith("+lr")
    jlr = (tuple(jnp.asarray(a) for a in lr[:3]) + tuple(jnp.float32(v) for v in lr[3:])
           if with_lr else None)
    tlr = tuple(torch.from_numpy(a) for a in lr[:3]) + lr[3:] if with_lr else None
    jx0, jU, tx0, tU = jnp.asarray(x0), jnp.asarray(U), torch.from_numpy(x0), torch.from_numpy(U)
    rtol, atol = TOL[pair]
    if mode.startswith("costs"):
        jc, jcrash = pallas_rollout.fused_rollout_costs(
            jdyn, jcost, jx0, jU, DT, tile_k=128, lr_params=jlr, split_cost=True)
        tc, tcrash = fr.fused_rollout_costs(dyn, cost, tx0, tU, DT, lr_params=tlr,
                                            split_cost=True)
    else:
        kind = "exp" if mode.startswith("epilogue") else "tsallis"
        jout = pallas_rollout.fused_weighted_rollout(
            jdyn, jcost, jx0, jU, DT, LAM, lr_params=jlr, tile_k=128, split_cost=True,
            weight_kind=kind, weight_params=(GAMMA, R_TS))
        tout = fr.fused_weighted_rollout(dyn, cost, tx0, tU, DT, LAM, lr_params=tlr,
                                         weight_kind=kind, weight_params=(GAMMA, R_TS),
                                         split_cost=True)
        jc, jcrash, tc, tcrash = jout[0], jout[1], tout[0], tout[1]
        for name, t, j in zip(("new mean", "baseline", "eta"), tout[2:], jout[2:]):
            _close(t, j, 2e-4, 3e-3, name)
    _close(tc, jc, rtol, atol, "costs")
    np.testing.assert_array_equal(tcrash.numpy(), np.asarray(jcrash))
    if pair == "ar":
        assert 0 < int(tcrash.sum()) < K  # a mixed crash population
    # the port's combined plain version on the same inputs
    cc, ccrash = fr.fused_rollout_costs(dyn, cost, tx0, tU, DT, lr_params=tlr,
                                        split_cost=False)
    assert torch.equal(ccrash, tcrash)
    _close(tc, cc, rtol, atol, "split vs combined costs")


def _normals(pair, kind, seed):
    K, T = SHAPES[pair]["B3"]
    z = np.random.default_rng(seed).normal(size=(2, K, T, C)).astype(np.float32)
    return z if kind == "nln" else z[0]


def _solve_mean(pair):
    T = SHAPES[pair]["B3"][1]
    t = np.arange(T, dtype=np.float32)[:, None]
    return (0.3 * np.sin(np.concatenate([t, 2 * t], axis=1))).astype(np.float32)


@pytest.mark.parametrize("pair", ["di", "ar"])
@pytest.mark.parametrize("kind,p", [("gaussian", 0.25), ("nln", 0.125)])
def test_b3_split_plain_matches_jax_split(pair, kind, p):
    (jdyn, jcost, jsamp), (dyn, cost, samp), x0 = _pair(pair, kind, p)
    K, _ = SHAPES[pair]["B3"]
    Z, mean = _normals(pair, kind, seed=len(kind)), _solve_mean(pair)
    jout = jax_solve(jdyn, jcost, jsamp, jnp.asarray(x0), jnp.asarray(mean), jnp.int32(0),
                     DT, LAM, ALPHA, K, optimization_stride=STRIDE, tile_k=128,
                     return_samples=True, injected_noise=jnp.asarray(Z), split_cost=True)
    args = (dyn, cost, samp, torch.from_numpy(x0), torch.from_numpy(mean), 0, DT, LAM,
            ALPHA, K)
    kw = dict(optimization_stride=STRIDE, return_samples=True,
              injected_noise=torch.from_numpy(Z))
    tout = fused_solve.fused_solve_iteration(*args, split_cost=True, **kw)
    costs, crash, new_mean, baseline, eta, U = tout
    j_costs, j_crash, j_mean, j_base, j_eta, j_U = (np.asarray(a) for a in jout)
    rtol, atol = TOL[pair]
    _close(U, j_U, 1e-5, 1e-6, "U")
    _close(costs, j_costs, rtol, atol, "costs")
    np.testing.assert_array_equal(crash.numpy(), j_crash)
    if pair == "ar":
        assert 0 < int(j_crash.sum()) < K  # a mixed crash population
    _close(baseline, j_base, 2e-4, 3e-3, "baseline")
    _close(eta, j_eta, 2e-4, 3e-3, "eta")
    _close(new_mean, j_mean, 2e-4, 3e-3, "new mean")
    # the port's combined plain version on the same normals: the same
    # samples, the costs summed in another order
    comb = fused_solve.fused_solve_iteration(*args, split_cost=False, **kw)
    assert torch.equal(comb[5], U) and torch.equal(comb[1], crash)
    _close(costs, comb[0], rtol, atol, "split vs combined costs")


@pytest.mark.parametrize("T", [3, 24, 150])
def test_split_sums_follow_the_cost_pass(T):
    """The plain cost pass sums as the kernel's threads do, checked bit for
    bit against a thread-by-thread simulation in numpy float32: eight chunks
    of ceil(T / 8) steps, each summed in order with the crash-1 value from
    the chunk's first trigger on and, apart, with the crash-1 values
    throughout; the chunks added in order, a chunk after one that fired
    taking its second sum. Values of mixed magnitude and sparse triggers, so
    another order or another selection would show."""
    rng = np.random.default_rng(T)
    K = 16
    scale = 10.0 ** rng.integers(-3, 6, size=(K, T))
    v0 = (rng.normal(size=(K, T)) * scale).astype(np.float32)
    v1 = (v0 + 1e4 * rng.random(size=(K, T))).astype(np.float32)
    trig = rng.random(size=(K, T)) < 0.03
    Tc = -(-T // 8)
    want_acc, want_crash = [], []
    for k in range(K):
        acc, crashed = np.float32(0.0), False
        for ch in range(8):
            sel = all1 = np.float32(0.0)
            fired = False
            for t in range(min(T, ch * Tc), min(T, (ch + 1) * Tc)):
                fired = fired or bool(trig[k, t])
                sel = np.float32(sel + (v1[k, t] if fired else v0[k, t]))
                all1 = np.float32(all1 + v1[k, t])
            acc = np.float32(acc + (all1 if crashed else sel))
            crashed = crashed or fired
        want_acc.append(acc)
        want_crash.append(int(crashed))
    acc, crash = fr.split_sums_plain(torch.from_numpy(v0), torch.from_numpy(v1),
                                     torch.from_numpy(trig))
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc, np.float32))
    np.testing.assert_array_equal(crash.numpy(), want_crash)
    # without triggers: the plain chunked sum of v0 and no crash
    acc0, crash0 = fr.split_sums_plain(torch.from_numpy(v0))
    assert not bool(crash0.any())
    sums = [np.float32(0.0)] * K
    for k in range(K):
        a = np.float32(0.0)
        for ch in range(8):
            c = np.float32(0.0)
            for t in range(min(T, ch * Tc), min(T, (ch + 1) * Tc)):
                c = np.float32(c + v0[k, t])
            a = np.float32(a + c)
        sums[k] = a
    np.testing.assert_array_equal(acc0.numpy(), np.asarray(sums, np.float32))


def test_auto_table_takes_only_measured_entries():
    """AUTO (split_cost=None) splits only for a (pair, kernel) of the
    measured table; any other eligible pair keeps the combined kernel."""
    (_, _, _), (dyn, cost, _), _ = _pair("di")
    for kernel in ("rollout", "solve", "rollout_x0"):
        assert fr.resolve_split(dyn, cost, None, kernel) == fr.AUTO_SPLIT.get(
            ("di_circle", kernel), False)
        assert fr.resolve_split(dyn, cost, True, kernel)
        assert not fr.resolve_split(dyn, cost, False, kernel)
    # the table holds a measured choice for B1 and B3 of every pair with
    # split entries, and for the per-sample-x0 B1 of the pairs that have one
    from mppi_generic_tpu_torch.ops import _build
    split_pairs = {p for p, kinds in _build.PAIR_KERNELS.items() if "split_dynamics" in kinds}
    x0_pairs = {p for p, kinds in _build.PAIR_KERNELS.items()
                if "split_dynamics_x0" in kinds}
    assert set(fr.AUTO_SPLIT) == ({(p, k) for p in split_pairs for k in ("rollout", "solve")}
                                  | {(p, "rollout_x0") for p in x0_pairs})
