"""Fused rollout + flash-epilogue kernels, their wrappers and plain versions.

Counterpart of ``mppi_generic_tpu/ops/pallas_rollout.py``: the hand-written
Hopper kernels in ``csrc/fused_rollout.cu`` replace its TPU kernel
``_fused_call`` in two modes.

* ``fused_rollout_costs``: per sample, a T-step rollout with running cost,
  terminal cost and (with ``lr_params``) the Gaussian likelihood-ratio cost
  accumulated in the loop. Returns (costs (K,), crash (K,)).
* ``fused_weighted_rollout``: the same, plus the online-softmax normExp
  epilogue. Kernel 1 reduces each block of samples into a carry row
  (m_b, d_b, num_b); kernel 2 (``flash_combine``) merges the rows into the
  new mean, baseline = -lambda * max(-J / lambda) and eta.

Each wrapper runs the kernel for CUDA tensors and the plain PyTorch version
(``*_plain``, in this module, with the same arithmetic) for CPU tensors.
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

from mppi_generic_tpu_torch.costs.double_integrator import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models.double_integrator import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.ops import _build

# samples per block of the rollout kernel (fused_rollout_block_size() in
# csrc/fused_rollout.cu): one epilogue carry row per block
BLOCK = 64
_MASKED = -1e30

# launches of each CUDA kernel since the last reset_launch_counts()
launch_counts = {"rollout_costs_kernel": 0, "flash_combine_kernel": 0}

# (dynamics, cost) pairs with a compiled kernel -> C entry point
_ROLLOUT_ENTRY = {
    (DoubleIntegratorDynamics, DoubleIntegratorCircleCost): "rollout_costs_di_circle",
}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def _f32(v) -> float:
    return float(np.float32(v))


def _div(x, v):
    """x / v rounded as one IEEE division, as the kernels divide. (On CUDA,
    PyTorch divides by a host scalar as a multiply by its reciprocal, which
    can differ in the last bit; a device scalar is divided by.)"""
    return x / x.new_full((), v)


def _lr_gain(lam, alpha) -> float:
    """0.5 * lambda * (1 - alpha) in float32, as the TPU kernel forms it."""
    return _f32(np.float32(0.5) * np.float32(lam)
                * (np.float32(1.0) - np.float32(alpha)))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def rollout_costs_plain(dynamics, cost, x0, U, dt, lr_params=None):
    """Plain version of kernel 1's rollout: (costs (K,), crash (K,) int32),
    the same operations in the same order as the kernel's thread loop."""
    K, T, C = U.shape
    Uc = U.permute(2, 1, 0)  # (C, T, K)
    x = x0[:, None].expand(-1, K)
    crash = torch.zeros((K,), dtype=torch.int32, device=U.device)
    acc = torch.zeros((K,), dtype=torch.float32, device=U.device)
    if lr_params is not None:
        mean, sigma, coeff, lam, alpha, pure_thresh = lr_params
        gain = _lr_gain(lam, alpha)
        pure = torch.arange(K, dtype=torch.float32, device=U.device) >= _f32(pure_thresh)
    y = None
    for t in range(T):
        u = Uc[:, t]
        x, y = dynamics.step(x, u, float(t), dt)
        c, crash = cost.running_cost(y, u, t, crash)
        if lr_params is not None:
            lr_t = torch.zeros_like(acc)
            for ch in range(C):
                mu = torch.where(pure, 0.0, mean[t, ch])
                sg = sigma[t, ch]
                lr_t = lr_t + coeff[ch] * mu * (mu - 2.0 * u[ch]) / (sg * sg)
            c = c + gain * lr_t
        acc = acc + c
    return _div(acc + cost.terminal_cost(y), T), crash


def block_carries_plain(costs, U, lam, block=BLOCK):
    """Plain version of kernel 1's epilogue: one carry row (m_b, d_b,
    num_b[T*C]) per block of ``block`` samples, (nb, 2 + T*C)."""
    K, T, C = U.shape
    nb = -(-K // block)
    pad = nb * block - K
    s = torch.nn.functional.pad(_div(-costs, lam), (0, pad), value=_MASKED)
    s = s.reshape(nb, block)
    m = torch.amax(s, dim=1)
    w = torch.exp(s - m[:, None])
    Up = torch.nn.functional.pad(U.reshape(K, T * C), (0, 0, 0, pad))
    num = torch.einsum("bk,bkj->bj", w, Up.reshape(nb, block, T * C))
    return torch.cat([m[:, None], w.sum(dim=1)[:, None], num], dim=1)


def flash_combine_plain(carry, T, C, lam):
    """Plain version of kernel 2: merge carry rows into (new_mean (T, C),
    baseline (), eta ()) with the flash rescaling of
    pallas_solve.flash_combine."""
    m, d, num = carry[:, 0], carry[:, 1], carry[:, 2:]
    m_g = torch.amax(m)
    sc = torch.exp(m - m_g)
    d_g = torch.sum(d * sc)
    num_g = torch.sum(num * sc[:, None], dim=0)
    return (num_g / d_g).reshape(T, C), -lam * m_g, d_g


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def _on_cpu(t) -> bool:
    """True for a CPU tensor (plain version), False for a CUDA tensor
    (kernel); any other device raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensors on {t.device} are not supported")
    return t.device.type == "cpu"


def _check_rollout_inputs(dynamics, cost, x0, U, lr_params):
    """The kernel's entry point for this (dynamics, cost) pair, after
    checking device, dtype, shape and contiguity of every input."""
    entry = _ROLLOUT_ENTRY.get((type(dynamics), type(cost)))
    if entry is None:
        raise NotImplementedError(
            f"no CUDA rollout kernel for {type(dynamics).__name__} with "
            f"{type(cost).__name__}")
    K, T, C = U.shape
    S = dynamics.STATE_DIM
    tensors = {"U": U, "x0": x0, "cost params": cost.params}
    if lr_params is not None:
        tensors.update(mean=lr_params[0], sigma=lr_params[1], coeff=lr_params[2])
    for name, t in tensors.items():
        if t.device != U.device:
            raise ValueError(f"{name} is on {t.device}, U on {U.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if C != dynamics.CONTROL_DIM or tuple(x0.shape) != (S,):
        raise ValueError(
            f"expected U (K, T, {dynamics.CONTROL_DIM}) and x0 ({S},), got "
            f"{tuple(U.shape)} and {tuple(x0.shape)}")
    if lr_params is not None and (
            tuple(lr_params[0].shape) != (T, C)
            or tuple(lr_params[1].shape) != (T, C)
            or tuple(lr_params[2].shape) != (C,)):
        raise ValueError("lr_params tables must be (T, C), (T, C), (C,)")
    if K < 1 or T < 1 or K * T * C >= 2**31:
        raise ValueError(f"unsupported sizes K={K}, T={T}, C={C}")
    return entry


@functools.lru_cache(maxsize=None)
def _lib():
    """The built kernel library, checked to agree with this module on the
    block size of kernel 1."""
    lib = _build.load("fused_rollout")
    if lib.fused_rollout_block_size() != BLOCK:
        raise RuntimeError("csrc/fused_rollout.cu and BLOCK disagree")
    return lib


def _check_status(status, what):
    if status != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {status}")


def _rollout_cuda(dynamics, cost, x0, U, dt, lr_params, lam_w):
    """Launch kernel 1; with ``lam_w`` set, in its epilogue mode."""
    entry = _check_rollout_inputs(dynamics, cost, x0, U, lr_params)
    lib = _lib()
    K, T, C = U.shape
    dev = U.device
    costs = torch.empty((K,), dtype=torch.float32, device=dev)
    crash = torch.empty((K,), dtype=torch.int32, device=dev)
    epilogue = lam_w is not None
    carry = (torch.empty((-(-K // BLOCK), 2 + T * C), dtype=torch.float32,
                         device=dev) if epilogue else None)
    if lr_params is None:
        lr = (None, None, None, 0.0, 0.0)
    else:
        mean, sigma, coeff, lam, alpha, pure_thresh = lr_params
        lr = (mean.data_ptr(), sigma.data_ptr(), coeff.data_ptr(),
              _lr_gain(lam, alpha), _f32(pure_thresh))
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = getattr(lib, entry)(
        dev.index, x0.data_ptr(), U.data_ptr(), K, T, _f32(dt),
        cost.params.data_ptr(), *lr, int(lr_params is not None), int(epilogue),
        _f32(lam_w if epilogue else 1.0), costs.data_ptr(), crash.data_ptr(),
        carry.data_ptr() if epilogue else None, stream)
    _check_status(status, "rollout_costs_kernel")
    launch_counts["rollout_costs_kernel"] += 1
    return costs, crash, carry


def fused_rollout_costs(dynamics, cost, x0, U, dt, lr_params=None):
    """Kernel 1, plain-costs mode: (costs (K,), crash (K,) int32).
    ``costs`` = (sum_t running [+ LR] + terminal) / T."""
    if _on_cpu(U):
        return rollout_costs_plain(dynamics, cost, x0, U, dt, lr_params)
    costs, crash, _ = _rollout_cuda(dynamics, cost, x0, U, dt, lr_params, None)
    return costs, crash


def rollout_block_carries(dynamics, cost, x0, U, dt, lam, lr_params=None):
    """Kernel 1, exp-epilogue mode: (costs, crash, carry (nb, 2 + T*C))."""
    if _on_cpu(U):
        costs, crash = rollout_costs_plain(dynamics, cost, x0, U, dt, lr_params)
        return costs, crash, block_carries_plain(costs, U, _f32(lam))
    return _rollout_cuda(dynamics, cost, x0, U, dt, lr_params, lam)


def flash_combine(carry, T, C, lam):
    """Kernel 2: (new_mean (T, C), baseline (), eta ()) from carry rows."""
    if _on_cpu(carry):
        return flash_combine_plain(carry, T, C, _f32(lam))
    if carry.dtype != torch.float32 or not carry.is_contiguous():
        raise ValueError("carry must be contiguous float32")
    if carry.dim() != 2 or carry.shape[1] != 2 + T * C or carry.shape[0] < 1:
        raise ValueError(f"carry must be (nb, {2 + T * C}), got {tuple(carry.shape)}")
    lib = _lib()
    new_mean = torch.empty((T, C), dtype=torch.float32, device=carry.device)
    scal = torch.empty((2,), dtype=torch.float32, device=carry.device)
    status = lib.flash_combine(
        carry.device.index, carry.data_ptr(), carry.shape[0], T * C, _f32(lam),
        new_mean.data_ptr(), scal.data_ptr(),
        torch.cuda.current_stream(carry.device).cuda_stream)
    _check_status(status, "flash_combine_kernel")
    launch_counts["flash_combine_kernel"] += 1
    return new_mean, scal[0], scal[1]


def fused_weighted_rollout(dynamics, cost, x0, U, dt, lam, lr_params=None):
    """Fused rollout + normExp flash epilogue for precomputed samples ``U``
    (K, T, C). Returns (costs (K,), crash (K,), new_mean (T, C),
    baseline (), eta ()), where baseline = -lambda * max_k(-J_k / lambda)
    and new_mean is the softmax(-J / lambda)-weighted mean of the samples."""
    K, T, C = U.shape
    costs, crash, carry = rollout_block_carries(dynamics, cost, x0, U, dt, lam,
                                                lr_params)
    new_mean, baseline, eta = flash_combine(carry, T, C, lam)
    return costs, crash, new_mean, baseline, eta
