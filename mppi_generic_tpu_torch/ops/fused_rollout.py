"""Fused rollout kernels, their wrappers and plain versions.

Counterpart of ``mppi_generic_tpu/ops/pallas_rollout.py``: the hand-written
Hopper kernel ``rollout_costs_kernel`` (``csrc/rollout_kernel.cuh``) replaces
its TPU kernel ``_fused_call`` in three modes, with ``flash_combine_kernel``
(``csrc/flash_combine.cu``) as the merge of its epilogue; the one in
``csrc/tsallis_reduce.cu`` its TPU kernel ``_tsallis_reduce_call``, the one
in ``csrc/rmppi_rollout.cu`` its TPU kernel ``_fused_rmppi_call``, and
``fused_sample_rollout_kernel`` (``csrc/sample_kernels.cuh``) its TPU kernel
``_fused_sample_call``.

* ``fused_rollout_costs``: per sample, a T-step rollout with running cost,
  terminal cost and (with ``lr_params``) the Gaussian likelihood-ratio cost
  accumulated in the loop. Returns (costs (K,), crash (K,)). ``x0`` is one
  state (S,) for all samples or one per sample (K, S) (RMPPI's candidate
  evaluation).
* ``fused_weighted_rollout``: the same, plus the online-softmax normExp
  epilogue. Kernel 1 reduces each block of samples into a carry row
  (m_b, d_b, num_b); kernel 2 (``flash_combine``) merges the rows into the
  new mean, baseline = -lambda * max(-J / lambda) and eta. With
  ``weight_kind="tsallis"`` the weights need the global minimum cost rho
  before any of them exists, so the epilogue takes two passes: kernel 1
  writes the costs and each block's minimum, the Tsallis reduction kernel
  (``tsallis_block_rows``) merges the minima into rho and writes one row
  (0, sum w, sum w U) per block, and the merge sums the rows in order.
* ``tsallis_reduce``: the reduction kernel against a given device rho,
  (sum w U, eta), for a rho merged elsewhere (across devices).
* ``fused_rmppi_rollout``: RMPPI's augmented rollout, the nominal and the
  real system of each sample stepped together, the real one with the DDP
  feedback K[t] (x_real - x_nom) in the loop.
* ``fused_sample_rollout_costs``: the samples drawn inside the kernel
  (Philox, ``ops/philox.py``) for the Gaussian, NLN and Smooth-MPPI
  samplers, with their carve-outs, the clamp, the per-step LR cost and the
  rollout; optionally (Smooth-MPPI) the flash epilogue over the derivative
  samples W. The helpers of the in-kernel draw (``noise_kind``, the tables,
  ``sample_plain``) are shared with ``ops/fused_solve.py``.

The rollout and sampling kernels are templates over the (dynamics, cost)
pair; each pair with an entry has its own source ``csrc/pair_<name>.cu`` and
library (``_PAIRS`` names them, ``_build.PAIR_KERNELS`` lists each pair's
kernels): the double integrator with its circle cost (every kernel) or
``QuadraticCost``; AutoRally's network dynamics with the standard or robust
AutoRally cost (the FNN and the track costmap inside the kernel); the
bicycle-slip model with the AutoRally costs on its output layout (the
rollout kernel only); the cartpole with its quadratic cost (every kernel);
the quadrotor with ``QuadrotorQuadraticCost`` or ``QuadrotorMapCost``; and
the Dubins car with ``QuadraticCost``. The RMPPI kernel has the double
integrator's entry only. Each pair reads its parameters through
``Dynamics.kernel_params`` and ``Cost.kernel_map`` besides the cost's
``params`` table.

Each wrapper runs the kernel for CUDA tensors and the plain PyTorch version
(``*_plain``, in this module, with the same arithmetic) for CPU tensors.
The plain versions step with ``Dynamics.kernel_step``, the model's step in
the kernels' order of operations.
There is no fallback: a CUDA tensor the kernel does not take raises. Every
launch adds one to ``launch_counts`` under the kernel's name.

``lr_params`` is ``(mean (T, C), sigma (T, C), coeff (C,), lam, alpha,
pure_threshold)`` as in the JAX package: tensors on the samples' device and
host floats.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from mppi_generic_tpu_torch.costs.autorally import ARRobustCost, ARStandardCost
from mppi_generic_tpu_torch.costs.cartpole import CartpoleQuadraticCost
from mppi_generic_tpu_torch.costs.double_integrator import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.costs.quadratic import QuadraticCost
from mppi_generic_tpu_torch.costs.quadrotor import QuadrotorMapCost, QuadrotorQuadraticCost
from mppi_generic_tpu_torch.models.autorally import AutorallyNNDynamics
from mppi_generic_tpu_torch.models.bicycle_slip import BicycleSlipDynamics
from mppi_generic_tpu_torch.models.cartpole import CartpoleDynamics
from mppi_generic_tpu_torch.models.double_integrator import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.models.dubins import DubinsDynamics
from mppi_generic_tpu_torch.models.quadrotor import QuadrotorDynamics
from mppi_generic_tpu_torch.ops import _build, philox
from mppi_generic_tpu_torch.ops._build import entry_counts, launch_counts, reset_launch_counts
from mppi_generic_tpu_torch.sampling.gaussian import GaussianDistribution
from mppi_generic_tpu_torch.sampling.nln import NLNDistribution
from mppi_generic_tpu_torch.sampling.smooth import SmoothMPPIDistribution
from mppi_generic_tpu_torch.utils.math_utils import true_div

__all__ = [
    "flash_combine",
    "fused_rmppi_rollout",
    "fused_rollout_costs",
    "fused_sample_rollout_costs",
    "fused_weighted_rollout",
    "launch_counts",
    "reset_launch_counts",
    "rollout_block_carries",
    "rollout_block_minima",
    "tsallis_block_rows",
    "tsallis_reduce",
]

# samples per block of the rollout and sampling kernels (kBlockSamples in
# csrc/mppi_common.cuh): one epilogue row per block
BLOCK = 64
_MASKED = -1e30
# a sample past K in the Tsallis pass-1 minimum (the TPU kernel's 1e30)
_MIN_PAD = 1e30
# the rollout kernel's epilogue modes (epilogue in csrc/rollout_kernel.cuh)
EPI_NONE, EPI_EXP, EPI_MIN = 0, 1, 2

# (dynamics, cost) -> the pair's name: its kernels are in the library of
# csrc/pair_<name>.cu (_build.PAIR_KERNELS lists which)
_PAIRS = {
    (DoubleIntegratorDynamics, DoubleIntegratorCircleCost): "di_circle",
    (AutorallyNNDynamics, ARStandardCost): "ar_nn",
    (AutorallyNNDynamics, ARRobustCost): "ar_nn",
    (BicycleSlipDynamics, ARStandardCost): "bicycle_ar",
    (BicycleSlipDynamics, ARRobustCost): "bicycle_ar",
    (CartpoleDynamics, CartpoleQuadraticCost): "cartpole",
    (QuadrotorDynamics, QuadrotorQuadraticCost): "quadrotor_quadratic",
    (QuadrotorDynamics, QuadrotorMapCost): "quadrotor_map",
    (DubinsDynamics, QuadraticCost): "dubins_quadratic",
    (DoubleIntegratorDynamics, QuadraticCost): "di_quadratic",
}
# what a pair's entries are compiled for, beyond the classes: the AutoRally
# cost's output_indices (the ARCostT template arguments) and QuadraticCost's
# output dimension (QuadraticCostT<O>)
_COST_LAYOUT = {
    "ar_nn": ("output_indices", (0, 1, 2, 3, 4, 5)),
    "bicycle_ar": ("output_indices", (0, 1, 2, 8, 5, 6)),
    "dubins_quadratic": ("OUTPUT_DIM", 3),
    "di_quadratic": ("OUTPUT_DIM", 4),
}
_RMPPI_ENTRY = {
    (DoubleIntegratorDynamics, DoubleIntegratorCircleCost): "rmppi_rollout_di_circle",
}
_KERNEL_NAMES = {"rollout": "rollout", "rollout_x0": "per-sample x0 rollout",
                 "solve": "solve", "sample": "sampling"}


def _entry(dynamics, cost, kind):
    """(library, C function) of kernel ``kind`` ("rollout", "rollout_x0",
    "solve" or "sample") for this (dynamics, cost) pair; raises
    NotImplementedError for a pair without one."""
    pair = _PAIRS.get((type(dynamics), type(cost)))
    entry = None if pair is None else _build.pair_entry(pair, kind)
    if entry is None:
        raise NotImplementedError(
            f"no CUDA {_KERNEL_NAMES[kind]} kernel for {type(dynamics).__name__} "
            f"with {type(cost).__name__}")
    return entry


# the samplers whose noise the fused sampling kernels draw (noise_kind in
# csrc/sample_kernels.cuh)
GAUSSIAN, NLN, SMOOTH = 0, 1, 2
_NOISE_KIND = {GaussianDistribution: GAUSSIAN, NLNDistribution: NLN,
               SmoothMPPIDistribution: SMOOTH}


def _f32(v) -> float:
    return float(np.float32(v))




def _tsallis_pw(r) -> float:
    """1 / (r - 1) in float32, as the TPU kernel's wrapper forms it
    (pallas_rollout.py:1589): the kernels multiply by it."""
    return _f32(np.float32(1.0) / (np.float32(r) - np.float32(1.0)))


def _lr_gain(lam, alpha) -> float:
    """0.5 * lambda * (1 - alpha) in float32, as the TPU kernel forms it."""
    return _f32(np.float32(0.5) * np.float32(lam)
                * (np.float32(1.0) - np.float32(alpha)))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def rollout_costs_plain(dynamics, cost, x0, U, dt, lr_params=None):
    """Plain version of kernel 1's rollout: (costs (K,), crash (K,) int32),
    the same operations in the same order as the kernel's thread loop.
    ``x0`` is (S,) or (K, S)."""
    K, T, C = U.shape
    Uc = U.permute(2, 1, 0)  # (C, T, K)
    x = x0.T if x0.dim() == 2 else x0[:, None].expand(-1, K)
    crash = torch.zeros((K,), dtype=torch.int32, device=U.device)
    acc = torch.zeros((K,), dtype=torch.float32, device=U.device)
    if lr_params is not None:
        mean, sigma, coeff, lam, alpha, pure_thresh = lr_params
        gain = _lr_gain(lam, alpha)
        pure = torch.arange(K, dtype=torch.float32, device=U.device) >= _f32(pure_thresh)
    y = None
    for t in range(T):
        u = Uc[:, t]
        x, y = dynamics.kernel_step(x, u, float(t), dt)
        c, crash = cost.running_cost(y, u, t, crash)
        if lr_params is not None:
            lr_t = torch.zeros_like(acc)
            for ch in range(C):
                mu = torch.where(pure, 0.0, mean[t, ch])
                sg = sigma[t, ch]
                lr_t = lr_t + coeff[ch] * mu * (mu - 2.0 * u[ch]) / (sg * sg)
            c = c + gain * lr_t
        acc = acc + c
    return true_div(acc + cost.terminal_cost(y), T), crash


def block_carries_plain(costs, U, lam, block=BLOCK):
    """Plain version of kernel 1's epilogue: one carry row (m_b, d_b,
    num_b[T*C]) per block of ``block`` samples, (nb, 2 + T*C)."""
    K, T, C = U.shape
    nb = -(-K // block)
    pad = nb * block - K
    s = torch.nn.functional.pad(true_div(-costs, lam), (0, pad), value=_MASKED)
    s = s.reshape(nb, block)
    m = torch.amax(s, dim=1)
    w = torch.exp(s - m[:, None])
    Up = torch.nn.functional.pad(U.reshape(K, T * C), (0, 0, 0, pad))
    num = torch.einsum("bk,bkj->bj", w, Up.reshape(nb, block, T * C))
    return torch.cat([m[:, None], w.sum(dim=1)[:, None], num], dim=1)


def block_minima_plain(costs, block=BLOCK):
    """Plain version of kernel 1's Tsallis pass 1: each block's minimum
    cost (nb,), 1e30 for the samples past K. A NaN cost gives a NaN
    minimum, as jnp.min does (the kernel does not use fminf, which drops
    NaN)."""
    K = costs.shape[0]
    nb = -(-K // block)
    s = torch.nn.functional.pad(costs, (0, nb * block - K), value=_MIN_PAD)
    return torch.amin(s.reshape(nb, block), dim=1)


def tsallis_rows_plain(U, costs, rho, gamma, pw, K_valid=None, block=BLOCK):
    """Plain version of the Tsallis reduction kernel against the minimum
    cost ``rho`` (0-d): per block of ``block`` samples one row (0, sum w,
    sum w U[TC]), (nb, 2 + T*C), summed left to right over the block's
    samples. w = (1 - dJ / gamma)^pw for dJ = J - rho < gamma, else 0, with
    pw = 1 / (r - 1) (the kernel multiplies by it), and 0 for samples at or
    past ``K_valid``, which the sums skip."""
    K, T, C = U.shape
    K_valid = K if K_valid is None else K_valid
    nb = -(-K // block)
    pad = nb * block - K
    dj = costs - rho
    base = torch.clamp(1.0 - true_div(dj, gamma), min=1e-30)
    w = torch.where(dj < gamma, torch.exp(torch.log(base) * pw), 0.0)
    valid = torch.arange(K, device=U.device) < K_valid
    w = torch.nn.functional.pad(torch.where(valid, w, 0.0), (0, pad)).reshape(nb, block)
    valid = torch.nn.functional.pad(valid, (0, pad)).reshape(nb, block)
    Up = torch.nn.functional.pad(U.reshape(K, T * C), (0, 0, 0, pad))
    Up = Up.reshape(nb, block, T * C)
    d = torch.zeros((nb,), dtype=torch.float32, device=U.device)
    num = torch.zeros((nb, T * C), dtype=torch.float32, device=U.device)
    for i in range(block):
        v = valid[:, i]
        d = torch.where(v, d + w[:, i], d)
        num = torch.where(v[:, None], num + w[:, i, None] * Up[:, i], num)
    return torch.cat([torch.zeros_like(d)[:, None], d[:, None], num], dim=1)


def rmppi_rollout_plain(dynamics, cost, x0_nom, x0_real, U, gains, sigma,
                        coeff, dt, lam, alpha):
    """Plain version of the RMPPI rollout kernel, the same operations in
    the same order as its thread loop: (s_nom, j_real, s_fb (K,),
    crash_real (K,) int32, U_real (K, T, C))."""
    K, T, C = U.shape
    S = x0_nom.shape[0]
    Uc = U.permute(2, 1, 0)  # (C, T, K)
    x_nom = x0_nom[:, None].expand(-1, K)
    x_real = x0_real[:, None].expand(-1, K)
    zeros = torch.zeros((K,), dtype=torch.float32, device=U.device)
    crash_n = torch.zeros((K,), dtype=torch.int32, device=U.device)
    crash_r = crash_n
    s_nom = j_real = s_fb = zeros
    gain = _lr_gain(lam, alpha)
    u_real_t = []
    for t in range(T):
        u_raw = Uc[:, t]
        u_nom = dynamics.enforce_constraints(x_nom, u_raw)
        dx = [x_real[s] - x_nom[s] for s in range(S)]
        u_fb = []
        fb_cost = zeros
        for ch in range(C):
            acc = gains[t, ch, 0] * dx[0]
            for s in range(1, S):
                acc = acc + gains[t, ch, s] * dx[s]
            u_fb.append(acc)
            sg = sigma[t, ch]
            fb_cost = fb_cost + coeff[ch] * acc * acc / (sg * sg)
        fb_cost = gain * fb_cost
        u_real = dynamics.enforce_constraints(x_real, u_raw + torch.stack(u_fb))
        u_real_t.append(u_real)
        x_nom, y_nom = dynamics.kernel_step(x_nom, u_nom, float(t), dt)
        x_real, y_real = dynamics.kernel_step(x_real, u_real, float(t), dt)
        c_nom, crash_n = cost.running_cost(y_nom, u_nom, t, crash_n)
        c_real, crash_r = cost.running_cost(y_real, u_real, t, crash_r)
        s_nom = s_nom + c_nom
        j_real = j_real + c_real
        s_fb = s_fb + c_real + fb_cost
    term_n, term_r = cost.terminal_cost(y_nom), cost.terminal_cost(y_real)
    U_real = torch.stack(u_real_t).permute(2, 0, 1).contiguous()
    return (true_div(s_nom + term_n, T), true_div(j_real + term_r, T),
            true_div(s_fb + term_r, T), crash_r, U_real)


def flash_combine_plain(carry, T, C, lam, with_num=False):
    """Plain version of kernel 2: merge carry rows into (new_mean (T, C),
    baseline (), eta ()) with the flash rescaling of
    pallas_solve.flash_combine; ``with_num`` adds the merged sum num (T, C)
    that new_mean = num / eta divides."""
    m, d, num = carry[:, 0], carry[:, 1], carry[:, 2:]
    m_g = torch.amax(m)
    sc = torch.exp(m - m_g)
    d_g = torch.sum(d * sc)
    num_g = torch.sum(num * sc[:, None], dim=0)
    out = ((num_g / d_g).reshape(T, C), -lam * m_g, d_g)
    return out + (num_g.reshape(T, C),) if with_num else out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _on_cpu(t) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {t.device} are not supported")
    return t.device.type == "cpu"


def _check_tensors(tensors, device):
    """Each tensor on ``device``, float32 and contiguous, as the kernels take
    them; an entry given as (tensor, shape) must also have that shape."""
    for name, t in tensors.items():
        t, shape = t if isinstance(t, tuple) else (t, None)
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def _model_args(dynamics, cost, device):
    """The (dynamics params, cost params, cost map) pointers of a launch,
    each checked as the kernels take it; the dynamics and the cost refuse
    what the compiled kernels do not take (another network), and so does a
    cost whose output layout differs from the one its pair's entries are
    compiled for (``_COST_LAYOUT``)."""
    pair = _PAIRS.get((type(dynamics), type(cost)))
    attr, want = _COST_LAYOUT.get(pair, (None, None))
    if attr is not None and getattr(cost, attr) != want:
        raise NotImplementedError(
            f"the CUDA entries of {pair} read the output layout {attr}={want}, not "
            f"{attr}={getattr(cost, attr)}")
    dyn_p, cmap = dynamics.kernel_params(), cost.kernel_map()
    tensors = {"cost params": cost.params}
    if dyn_p is not None:
        tensors["dynamics params"] = dyn_p
    if cmap is not None:
        tensors["cost map"] = cmap
    _check_tensors(tensors, device)
    return _ptr(dyn_p), cost.params.data_ptr(), _ptr(cmap)


def _check_rollout_inputs(dynamics, cost, x0, U, lr_params):
    """(library, C function) of the kernel for this (dynamics, cost) pair,
    after checking device, dtype, shape and contiguity of every input."""
    entry = _entry(dynamics, cost, "rollout_x0" if x0.dim() == 2 else "rollout")
    K, T, C = U.shape
    S = dynamics.STATE_DIM
    tensors = {"U": U, "x0": x0}
    if lr_params is not None:
        tensors.update(mean=lr_params[0], sigma=lr_params[1], coeff=lr_params[2])
    _check_tensors(tensors, U.device)
    if C != dynamics.CONTROL_DIM or tuple(x0.shape) not in ((S,), (K, S)):
        raise ValueError(
            f"expected U (K, T, {dynamics.CONTROL_DIM}) and x0 ({S},) or "
            f"(K, {S}), got {tuple(U.shape)} and {tuple(x0.shape)}")
    if lr_params is not None and (
            tuple(lr_params[0].shape) != (T, C)
            or tuple(lr_params[1].shape) != (T, C)
            or tuple(lr_params[2].shape) != (C,)):
        raise ValueError("lr_params tables must be (T, C), (T, C), (C,)")
    if K < 1 or T < 1 or K * T * C >= 2**31:
        raise ValueError(f"unsupported sizes K={K}, T={T}, C={C}")
    return entry


@functools.lru_cache(maxsize=None)
def _lib(name="flash_combine"):
    """The built kernel library ``name`` (the merge's by default), after
    checking that csrc/ agrees with this module on the samples per block of
    the rollout and sampling kernels."""
    merge = _build.load("flash_combine")
    if merge.kernel_block_size() != BLOCK:
        raise RuntimeError("csrc/mppi_common.cuh kBlockSamples and BLOCK disagree")
    return merge if name == "flash_combine" else _build.load(name)


def _check_status(status, what):
    if status != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {status}")


def _rollout_cuda(dynamics, cost, x0, U, dt, lr_params, epilogue=EPI_NONE,
                  lam_w=1.0):
    """Launch kernel 1 in the ``epilogue`` mode: (costs, crash, out), out the
    carry rows (EPI_EXP), the block minima (EPI_MIN) or None."""
    lib_name, entry = _check_rollout_inputs(dynamics, cost, x0, U, lr_params)
    lib = _lib(lib_name)
    K, T, C = U.shape
    dev = U.device
    nb = -(-K // BLOCK)
    costs = torch.empty((K,), dtype=torch.float32, device=dev)
    crash = torch.empty((K,), dtype=torch.int32, device=dev)
    out = None
    if epilogue != EPI_NONE:
        out = torch.empty((nb, 2 + T * C) if epilogue == EPI_EXP else (nb,),
                          dtype=torch.float32, device=dev)
    if lr_params is None:
        lr = (None, None, None, 0.0, 0.0)
    else:
        mean, sigma, coeff, lam, alpha, pure_thresh = lr_params
        lr = (mean.data_ptr(), sigma.data_ptr(), coeff.data_ptr(),
              _lr_gain(lam, alpha), _f32(pure_thresh))
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = getattr(lib, entry)(
        dev.index, x0.data_ptr(), U.data_ptr(), K, T, _f32(dt),
        *_model_args(dynamics, cost, dev), *lr, int(lr_params is not None),
        epilogue, int(x0.dim() == 2), _f32(lam_w), costs.data_ptr(),
        crash.data_ptr(), _ptr(out), stream)
    _check_status(status, "rollout_costs_kernel")
    _build.count_launch("rollout_costs_kernel", entry)
    return costs, crash, out


def fused_rollout_costs(dynamics, cost, x0, U, dt, lr_params=None):
    """Kernel 1, plain-costs mode: (costs (K,), crash (K,) int32).
    ``costs`` = (sum_t running [+ LR] + terminal) / T. ``x0`` is (S,), or
    (K, S) for one initial state per sample."""
    if _on_cpu(U):
        return rollout_costs_plain(dynamics, cost, x0, U, dt, lr_params)
    costs, crash, _ = _rollout_cuda(dynamics, cost, x0, U, dt, lr_params)
    return costs, crash


def rollout_block_carries(dynamics, cost, x0, U, dt, lam, lr_params=None):
    """Kernel 1, exp-epilogue mode: (costs, crash, carry (nb, 2 + T*C))."""
    if _on_cpu(U):
        costs, crash = rollout_costs_plain(dynamics, cost, x0, U, dt, lr_params)
        return costs, crash, block_carries_plain(costs, U, _f32(lam))
    return _rollout_cuda(dynamics, cost, x0, U, dt, lr_params, EPI_EXP, lam)


def rollout_block_minima(dynamics, cost, x0, U, dt, lr_params=None):
    """Kernel 1, Tsallis pass 1: (costs, crash, block minima (nb,)), each
    block's minimum over its valid costs (NaN if one is NaN)."""
    if _on_cpu(U):
        costs, crash = rollout_costs_plain(dynamics, cost, x0, U, dt, lr_params)
        return costs, crash, block_minima_plain(costs)
    return _rollout_cuda(dynamics, cost, x0, U, dt, lr_params, EPI_MIN)


@functools.lru_cache(maxsize=None)
def _tsallis_lib():
    """The library of csrc/tsallis_reduce.cu, checked to agree with this
    module on the samples per block."""
    lib = _build.load("tsallis_reduce")
    if lib.tsallis_reduce_block_size() != BLOCK:
        raise RuntimeError("csrc/tsallis_reduce.cu and BLOCK disagree")
    return lib


def tsallis_block_rows(U, costs, rho_src, gamma, r, K_valid=None):
    """The Tsallis reduction kernel (pass 2): rho = the minimum of
    ``rho_src`` (the rollout's block minima, or one given rho; NaN if one is
    NaN), then per block of BLOCK samples the row (0, sum w, sum w U[TC]).
    Returns (rows (nb, 2 + T*C), rho ()). Samples at or past ``K_valid``
    (default K) weigh 0. ``rho_src`` is a 1-d float32 tensor on the samples'
    device, so no host waits for it; the inputs are checked on every
    device."""
    K, T, C = U.shape
    K_valid = K if K_valid is None else int(K_valid)
    _check_tensors({"U": U, "costs": (costs, (K,)), "rho": rho_src}, U.device)
    if rho_src.dim() != 1 or rho_src.numel() < 1:
        raise ValueError(f"rho must be a non-empty 1-d tensor, got {tuple(rho_src.shape)}")
    if not 0 <= K_valid <= K or K < 1 or K * T * C >= 2**31:
        raise ValueError(f"unsupported sizes K={K}, K_valid={K_valid}, T={T}, C={C}")
    gamma, pw = _f32(gamma), _tsallis_pw(r)
    if _on_cpu(U):
        rho = torch.amin(rho_src)
        return tsallis_rows_plain(U, costs, rho, gamma, pw, K_valid), rho
    dev = U.device
    rows = torch.empty((-(-K // BLOCK), 2 + T * C), dtype=torch.float32, device=dev)
    rho = torch.empty((), dtype=torch.float32, device=dev)
    status = _tsallis_lib().tsallis_reduce(
        dev.index, U.data_ptr(), costs.data_ptr(), rho_src.data_ptr(), rho_src.numel(),
        K_valid, K, T * C, gamma, pw, rows.data_ptr(), rho.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _check_status(status, "tsallis_reduce_kernel")
    _build.count_launch("tsallis_reduce_kernel")
    return rows, rho


def flash_combine(carry, T, C, lam, with_num=False):
    """Kernel 2: (new_mean (T, C), baseline (), eta ()) from carry rows;
    ``with_num`` adds the merged sum num (T, C) = new_mean * eta before the
    division."""
    if _on_cpu(carry):
        return flash_combine_plain(carry, T, C, _f32(lam), with_num)
    if carry.dtype != torch.float32 or not carry.is_contiguous():
        raise ValueError("carry must be contiguous float32")
    if carry.dim() != 2 or carry.shape[1] != 2 + T * C or carry.shape[0] < 1:
        raise ValueError(f"carry must be (nb, {2 + T * C}), got {tuple(carry.shape)}")
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=carry.device)
    new_mean = torch.empty((T, C), **f32)
    scal = torch.empty((2,), **f32)
    num = torch.empty((T, C), **f32) if with_num else None
    status = lib.flash_combine(
        carry.device.index, carry.data_ptr(), carry.shape[0], T * C, _f32(lam),
        new_mean.data_ptr(), scal.data_ptr(), _ptr(num),
        torch.cuda.current_stream(carry.device).cuda_stream)
    _check_status(status, "flash_combine_kernel")
    _build.count_launch("flash_combine_kernel")
    out = (new_mean, scal[0], scal[1])
    return out + (num,) if with_num else out


def fused_weighted_rollout(dynamics, cost, x0, U, dt, lam, lr_params=None,
                           weight_kind="exp", weight_params=None):
    """Fused rollout + in-kernel weights + weighted mean for precomputed
    samples ``U`` (K, T, C). Returns (costs (K,), crash (K,), new_mean
    (T, C), baseline (), eta ()).

    ``weight_kind="exp"``: the normExp flash epilogue; baseline = -lambda *
    max_k(-J_k / lambda) and new_mean is the softmax(-J / lambda)-weighted
    mean. ``"tsallis"`` with ``weight_params = (gamma, r)``
    (TsallisTransform, mppi_common.cu:958-985): the two-pass epilogue;
    baseline = rho = min_k J_k, eta = sum_k w_k and new_mean = sum_k w_k U_k
    / eta with w = (1 - (J - rho) / gamma)_+^(1 / (r - 1)). Three launches,
    in stream order: kernel 1 with the block minima, the reduction kernel,
    the merge; nothing waits on the host."""
    K, T, C = U.shape
    if weight_kind == "tsallis":
        gamma, r = weight_params
        costs, crash, minima = rollout_block_minima(dynamics, cost, x0, U, dt,
                                                    lr_params)
        rows, rho = tsallis_block_rows(U, costs, minima, gamma, r)
        new_mean, _, eta = flash_combine(rows, T, C, 1.0)
        return costs, crash, new_mean, rho, eta
    if weight_kind != "exp":
        raise ValueError(f"weight_kind must be 'exp' or 'tsallis', got {weight_kind!r}")
    costs, crash, carry = rollout_block_carries(dynamics, cost, x0, U, dt, lam,
                                                lr_params)
    new_mean, baseline, eta = flash_combine(carry, T, C, lam)
    return costs, crash, new_mean, baseline, eta


def tsallis_reduce(U, costs, rho, gamma, r, K=None):
    """Tsallis weights against a given minimum cost ``rho`` (a device
    tensor, 0-d or (1,), e.g. all-reduced across devices), their weighted
    sum of ``U`` (K_rows, T, C) and their sum: (num (T, C), eta ()), the
    JAX ``_tsallis_reduce_call``. Samples at or past ``K`` (default all)
    weigh 0. Two launches: the reduction kernel and the merge."""
    _, T, C = U.shape
    rows, _ = tsallis_block_rows(U, costs, rho.reshape(1), gamma, r, K)
    _, _, eta, num = flash_combine(rows, T, C, 1.0, with_num=True)
    return num, eta


@functools.lru_cache(maxsize=None)
def _rmppi_lib():
    return _build.load("rmppi_rollout")


def fused_rmppi_rollout(dynamics, cost, x0_nom, x0_real, U, gains, sigma, coeff,
                        dt, lam, alpha):
    """Fused RMPPI augmented rollout (rolloutRMPPIDynamicsKernel +
    rolloutRMPPICostKernel, core/rmppi_kernels.cu:359-665): per sample the
    nominal and the real system step together; the nominal one with
    u_nom = clamp(u_raw), the real one with u_real = clamp(u_raw + u_fb),
    u_fb = K[t] (x_real - x_nom); the feedback cost
    0.5 lambda (1 - alpha) sum_c coeff_c u_fb_c^2 / sigma_tc^2 accumulates
    beside the running costs. "clamp" is the dynamics' enforce_constraints.

    U (K, T, C) holds the raw samples (not clamped: the kernel clamps both
    controls). gains (T, C, S); sigma (T, C); coeff (C,). Returns
    (s_nom, j_real, s_fb (K,), crash_real (K,) int32, U_real (K, T, C)):
    s_nom = (sum running_nom + terminal) / T, j_real the same for the real
    system, s_fb = (sum (running_real + fb cost) + terminal_real) / T.
    The inputs are checked as the kernel takes them on every device."""
    K, T, C = U.shape
    S = dynamics.STATE_DIM
    constraints = constraint_table(dynamics)
    _check_tensors({"U": U, "x0_nom": (x0_nom, (S,)), "x0_real": (x0_real, (S,)),
                    "gains": (gains, (T, C, S)), "sigma": (sigma, (T, C)),
                    "coeff": (coeff, (C,)), "cost params": cost.params,
                    "constraints": constraints}, U.device)
    if C != dynamics.CONTROL_DIM or K < 1 or T < 1 or K * T * C >= 2**31:
        raise ValueError(f"unsupported sizes K={K}, T={T}, C={C}")
    if _on_cpu(U):
        return rmppi_rollout_plain(dynamics, cost, x0_nom, x0_real, U, gains,
                                   sigma, coeff, dt, lam, alpha)
    entry = _RMPPI_ENTRY.get((type(dynamics), type(cost)))
    if entry is None:
        raise NotImplementedError(
            f"no CUDA RMPPI rollout kernel for {type(dynamics).__name__} with "
            f"{type(cost).__name__}")
    dev = U.device
    f32 = dict(dtype=torch.float32, device=dev)
    s_nom, j_real, s_fb = (torch.empty((K,), **f32) for _ in range(3))
    crash = torch.empty((K,), dtype=torch.int32, device=dev)
    U_real = torch.empty((K, T, C), **f32)
    status = getattr(_rmppi_lib(), entry)(
        dev.index, x0_nom.data_ptr(), x0_real.data_ptr(), U.data_ptr(), K, T,
        _f32(dt), cost.params.data_ptr(), constraints.data_ptr(),
        gains.data_ptr(), sigma.data_ptr(), coeff.data_ptr(),
        _lr_gain(lam, alpha), s_nom.data_ptr(), j_real.data_ptr(),
        s_fb.data_ptr(), crash.data_ptr(), U_real.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _check_status(status, "rmppi_rollout_kernel")
    _build.count_launch("rmppi_rollout_kernel", entry)
    return s_nom, j_real, s_fb, crash, U_real


# ---------------------------------------------------------------------------
# the in-kernel draw (shared with ops/fused_solve.py)
# ---------------------------------------------------------------------------
def noise_kind(sampler) -> int:
    """GAUSSIAN, NLN or SMOOTH: which noise the fused sampling kernels draw
    for ``sampler``. Any other sampler raises, as the JAX kernels refuse it
    (pallas_rollout.py:2520-2535)."""
    kind = _NOISE_KIND.get(type(sampler))
    if kind is None:
        raise NotImplementedError(
            "the fused sampling kernels draw the noise of the Gaussian, NLN and "
            f"Smooth-MPPI samplers, not of {type(sampler).__name__}")
    return kind


def constraint_table(dynamics):
    """(4, C) [lo; hi; deadband; zero control]: the dynamics'
    enforceConstraints as the kernels read it."""
    return torch.stack([dynamics.control_ranges[:, 0], dynamics.control_ranges[:, 1],
                        dynamics.control_deadband, dynamics.zero_control]).contiguous()


def sample_tables(sampler, kind, mean, iteration, sampler_state=None):
    """(sigma (T, C), aux (T, C) or None) of one iteration: the decayed
    sigma, and NLN's lognormal scale (the RAW std-dev, not the decayed one,
    pallas_rollout.py:2570-2581) or Smooth-MPPI's derivative mean."""
    T, C = mean.shape
    sigma = sampler._sigma(T, iteration).contiguous()
    if kind == NLN:
        return sigma, sampler.std_dev.expand(T, C).contiguous()
    if kind == SMOOTH:
        if sampler_state is None:
            raise ValueError("Smooth-MPPI needs sampler_state (the derivative mean)")
        return sigma, sampler_state
    return sigma, None


def standard_normals(kind, seed, K, T, C, injected_noise=None):
    """(n_z, K, T, C) standard normals of one iteration (n_z = 2 for NLN's
    z and z2): ``injected_noise`` when given, (K, T, C) or (n_z, K, T, C),
    else the kernels' Philox draw from ``seed``."""
    n_z = 2 if kind == NLN else 1
    if injected_noise is None:
        return philox.normals(seed, K, T, C, streams=n_z)
    z = injected_noise[None] if injected_noise.dim() == 3 else injected_noise
    if tuple(z.shape) != (n_z, K, T, C):
        raise ValueError(f"injected_noise must be ({n_z}, {K}, {T}, {C}), got "
                         f"{tuple(injected_noise.shape)}")
    return z


def sample_plain(dynamics, sampler, kind, mean, seed, K, iteration, stride,
                 sampler_state=None, injected_noise=None):
    """The kernels' draw, carve-outs and clamp, with the same float
    operations: the eager sampler applied to the kernels' normals, then the
    dynamics' clamp. Returns (U (K, T, C), W (K, T, C) or None)."""
    T, C = mean.shape
    z = standard_normals(kind, seed, K, T, C, injected_noise)
    U, W = sampler.sample(None, mean, K, iteration=iteration,
                          optimization_stride=stride, state=sampler_state,
                          injected_noise=z if kind == NLN else z[0])
    return dynamics.enforce_constraints(None, U.movedim(-1, 0)).movedim(0, -1), W


def _rollout_sums(dynamics, cost, x0, U, dt, step_extra=None):
    """The sampling kernels' rollout loop from one x0 (S,): (acc, terminal,
    crash), acc = sum_t (running_t [+ step_extra(t, u_t)]) summed as
    (acc + running) + extra."""
    K, T, C = U.shape
    Uc = U.permute(2, 1, 0)  # (C, T, K)
    x = x0[:, None].expand(-1, K)
    crash = torch.zeros((K,), dtype=torch.int32, device=U.device)
    acc = torch.zeros((K,), dtype=torch.float32, device=U.device)
    y = None
    for t in range(T):
        u = Uc[:, t]
        x, y = dynamics.kernel_step(x, u, float(t), dt)
        c, crash = cost.running_cost(y, u, t, crash)
        acc = acc + c
        if step_extra is not None:
            acc = acc + step_extra(t, u)
    return acc, cost.terminal_cost(y), crash


def _seed_tensor(seed, device):
    """The iteration's seed as the kernels read it: a 0-d int32 tensor on
    ``device`` (the controllers draw it there, so no solve waits on it)."""
    if not isinstance(seed, torch.Tensor):
        return torch.tensor(int(seed), dtype=torch.int32, device=device)
    if seed.device != device or seed.dtype != torch.int32 or seed.numel() != 1:
        raise ValueError(f"seed must be one int32 on {device}, got {seed.dtype} "
                         f"{tuple(seed.shape)} on {seed.device}")
    return seed.reshape(())


def _ptr(t):
    return None if t is None else t.data_ptr()


def sample_rollout_plain(dynamics, cost, sampler, x0, mean, seed, dt, lam, alpha,
                         num_rollouts, iteration=0, optimization_stride=0,
                         sampler_state=None, injected_noise=None):
    """Plain version of ``fused_sample_rollout_kernel``: (costs (K,), crash
    (K,) int32, U (K, T, C), W (K, T, C) or None), the kernel's operations
    in its order. The LR term of each step is scaled and added to the
    running sum (pallas_rollout.py:1811-1828), J = (acc + terminal) / T."""
    kind = noise_kind(sampler)
    K = num_rollouts
    T, C = mean.shape
    sigma, _ = sample_tables(sampler, kind, mean, iteration, sampler_state)
    U, W = sample_plain(dynamics, sampler, kind, mean, seed, K, iteration,
                        optimization_stride, sampler_state, injected_noise)
    coeff = sampler.control_cost_coeff
    gain = _lr_gain(lam, alpha)
    pure_k = sampler._pure_noise_mask(K)

    def lr_step(t, u):
        lr_t = torch.zeros_like(u[0])
        for ch in range(C):
            mu = torch.where(pure_k, 0.0, mean[t, ch])
            sg = sigma[t, ch]
            lr_t = lr_t + coeff[ch] * mu * (mu - 2.0 * u[ch]) / (sg * sg)
        return gain * lr_t

    acc, term, crash = _rollout_sums(dynamics, cost, x0, U, dt, lr_step)
    return true_div(acc + term, T), crash, U, W


def _sample_rollout_cuda(dynamics, cost, sampler, kind, x0, mean, seed, dt, lam,
                         alpha, K, iteration, stride, sampler_state, epilogue,
                         emit_samples, injected_noise):
    """Launch ``fused_sample_rollout_kernel``: (costs, crash, U or None,
    W or None, carry or None)."""
    lib_name, entry = _entry(dynamics, cost, "sample")
    T, C = mean.shape
    S = dynamics.STATE_DIM
    dev = mean.device
    sigma, aux = sample_tables(sampler, kind, mean, iteration, sampler_state)
    cons = constraint_table(dynamics)
    z = (None if injected_noise is None
         else standard_normals(kind, seed, K, T, C, injected_noise))
    tensors = {"x0": (x0, (S,)), "mean": (mean, (T, C)), "sigma": sigma,
               "coeff": (sampler.control_cost_coeff, (C,)), "constraints": cons}
    if aux is not None:
        tensors["aux"] = (aux, (T, C))
    if z is not None:
        tensors["injected_noise"] = z
    _check_tensors(tensors, dev)
    if C != dynamics.CONTROL_DIM or K < 1 or T < 1 or 2 * K * T * C >= 2**31:
        raise ValueError(f"unsupported sizes K={K}, T={T}, C={C}")
    model = _model_args(dynamics, cost, dev)
    seed = _seed_tensor(seed, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    costs = torch.empty((K,), **f32)
    crash = torch.empty((K,), dtype=torch.int32, device=dev)
    U = torch.empty((K, T, C), **f32) if emit_samples or not epilogue else None
    W = torch.empty((K, T, C), **f32) if kind == SMOOTH else None
    carry = torch.empty((-(-K // BLOCK), 2 + T * C), **f32) if epilogue else None
    status = getattr(_lib(lib_name), entry)(
        dev.index, kind, int(epilogue), x0.data_ptr(), mean.data_ptr(),
        sigma.data_ptr(), _ptr(aux), sampler.control_cost_coeff.data_ptr(),
        cons.data_ptr(), seed.data_ptr(), _ptr(z), K, T, int(stride),
        _f32(sampler.pure_threshold(K)),
        _f32(getattr(sampler, "dt_smooth", 0.0)), _f32(dt), _lr_gain(lam, alpha),
        _f32(lam), *model, costs.data_ptr(), crash.data_ptr(),
        _ptr(U), _ptr(W), _ptr(carry), torch.cuda.current_stream(dev).cuda_stream)
    _check_status(status, "fused_sample_rollout_kernel")
    _build.count_launch("fused_sample_rollout_kernel", entry)
    return costs, crash, U, W, carry


def fused_sample_rollout_costs(dynamics, cost, sampler, x0, mean, seed, dt, lam,
                               alpha, num_rollouts, iteration=0,
                               optimization_stride=0, sampler_state=None,
                               epilogue=False, emit_samples=True,
                               injected_noise=None):
    """Fused sample + rollout (the JAX ``fused_sample_rollout_costs``,
    pallas_rollout.py:2457-2515): the samples are drawn in the kernel from
    ``seed`` (a 0-d int32 tensor on the samples' device), carved out,
    clamped and rolled out with the per-step LR cost. Returns
    (costs (K,), crash (K,), U (K, T, C), aux), where aux is Smooth-MPPI's
    derivative samples W (K, T, C), else None.

    ``epilogue=True`` (Smooth-MPPI only): the flash normExp epilogue over W,
    which Smooth-MPPI's mean update weights (smooth-MPPI.cu:203-236).
    Returns (costs, crash, U or None, new_deriv_mean (T, C), baseline, eta);
    U only with ``emit_samples``.

    ``injected_noise`` replaces the draw with given standard normals:
    (K, T, C), or (2, K, T, C) for NLN (z, z2). ``optimization_stride`` is a
    host integer. Samplers other than Gaussian, NLN and Smooth-MPPI raise;
    CPU tensors run the plain version, CUDA tensors the kernel."""
    kind = noise_kind(sampler)
    if epilogue and kind != SMOOTH:
        raise NotImplementedError(
            "the sampling kernel's flash epilogue is Smooth-MPPI's, over W; the "
            "Gaussian and NLN samplers take fused_solve_iteration")
    T, C = mean.shape
    K = num_rollouts
    if _on_cpu(mean):
        costs, crash, U, W = sample_rollout_plain(
            dynamics, cost, sampler, x0, mean, seed, dt, lam, alpha, K, iteration,
            optimization_stride, sampler_state, injected_noise)
        if not epilogue:
            return costs, crash, U, W
        carry = block_carries_plain(costs, W, _f32(lam))
    else:
        costs, crash, U, W, carry = _sample_rollout_cuda(
            dynamics, cost, sampler, kind, x0, mean, seed, dt, lam, alpha, K,
            iteration, optimization_stride, sampler_state, epilogue, emit_samples,
            injected_noise)
        if not epilogue:
            return costs, crash, U, W
    new_dm, baseline, eta = flash_combine(carry, T, C, lam)
    return costs, crash, U if emit_samples else None, new_dm, baseline, eta
