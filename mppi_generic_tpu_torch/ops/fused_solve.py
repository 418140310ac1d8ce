"""The fused solve iteration (kernel B3), its wrapper and plain version.

Counterpart of ``mppi_generic_tpu/ops/pallas_solve.py``: the hand-written
Hopper kernel ``fused_solve_kernel`` (``csrc/sample_kernels.cuh``, one entry
per (dynamics, cost) pair in ``csrc/pair_<name>.cu``) replaces its TPU kernel
``_fused_solve_call``. One launch is one MPPI iteration for the
Gaussian and the NLN sampler: the normals drawn in the kernel (Philox,
``ops/philox.py``), the carve-outs, the clamp, the likelihood-ratio cost
(summed apart and added at the end), the rollout and one flash carry row per
block of samples; ``flash_combine_kernel`` then merges the rows into the new
mean, baseline and eta.

The kernel has an entry for each pair of ``ops/fused_rollout._PAIRS`` that
``_build.PAIR_KERNELS`` gives a "solve" kernel: the double integrator with
its circle cost or ``QuadraticCost``, AutoRally's network dynamics with the
standard or robust AutoRally cost (the FNN step and the costmap query
inside the kernel), the cartpole, the quadrotor with either of its costs and
the Dubins car. CPU tensors
run the plain version (``fused_solve_plain``, the kernel's operations in
its order), CUDA tensors the kernel. There is no fallback: a sampler, or a
(dynamics, cost) pair, the kernel does not take raises.
"""

from __future__ import annotations

import torch

from mppi_generic_tpu_torch.ops import _build
from mppi_generic_tpu_torch.ops import fused_rollout as fr
from mppi_generic_tpu_torch.utils.math_utils import true_div

__all__ = ["fused_solve_carries", "fused_solve_iteration", "fused_solve_plain"]

def _solve_kind(sampler) -> int:
    kind = fr.noise_kind(sampler)
    if kind == fr.SMOOTH:
        raise NotImplementedError(
            "the fused solve kernel draws the Gaussian and NLN samplers' noise; "
            "Smooth-MPPI takes fused_sample_rollout_costs(epilogue=True)")
    return kind


def _tables(sampler, kind, mean, iteration):
    """(sigma, aux, lrc) of one iteration; lrc = coeff / sigma^2 is formed
    here, outside the kernel, as the JAX package forms it (pallas_solve.py:
    590)."""
    sigma, aux = fr.sample_tables(sampler, kind, mean, iteration)
    lrc = (sampler.control_cost_coeff[None, :] / (sigma * sigma)).contiguous()
    return sigma, aux, lrc


def fused_solve_plain(dynamics, cost, sampler, x0, mean, seed, dt, lam, alpha,
                      num_rollouts, iteration=0, optimization_stride=0,
                      injected_noise=None):
    """Plain version of ``fused_solve_kernel``: (costs (K,), crash (K,) int32,
    U (K, T, C), carry (nb, 2 + T*C)), the kernel's operations in its order:
    the sampler's carve-outs, the clamp, the LR sum lr += lrc mu (mu - 2 u)
    over t, then c, kept apart from the running sum, and J = (acc +
    terminal + gain lr) / T (pallas_solve.py:176-240, :349)."""
    kind = _solve_kind(sampler)
    K = num_rollouts
    T, C = mean.shape
    _, _, lrc = _tables(sampler, kind, mean, iteration)
    U, _ = fr.sample_plain(dynamics, sampler, kind, mean, seed, K, iteration,
                           optimization_stride, injected_noise=injected_noise)
    mu = torch.where(sampler._pure_noise_mask(K)[:, None, None], 0.0, mean)
    lr = torch.zeros((K,), dtype=torch.float32, device=mean.device)
    for t in range(T):
        for c in range(C):
            m = mu[:, t, c]
            lr = lr + lrc[t, c] * m * (m - 2.0 * U[:, t, c])
    acc, term, crash = fr._rollout_sums(dynamics, cost, x0, U, dt)
    costs = true_div(acc + term + fr._lr_gain(lam, alpha) * lr, T)
    return costs, crash, U, fr.block_carries_plain(costs, U, fr._f32(lam))


def _fused_solve_cuda(dynamics, cost, sampler, kind, x0, mean, seed, dt, lam, alpha,
                      K, iteration, stride, injected_noise):
    """Launch ``fused_solve_kernel``: (costs, crash, U, carry)."""
    lib_name, entry = fr._entry(dynamics, cost, "solve")
    T, C = mean.shape
    S = dynamics.STATE_DIM
    dev = mean.device
    sigma, aux, lrc = _tables(sampler, kind, mean, iteration)
    cons = fr.constraint_table(dynamics)
    z = (None if injected_noise is None
         else fr.standard_normals(kind, seed, K, T, C, injected_noise))
    tensors = {"x0": (x0, (S,)), "mean": (mean, (T, C)), "sigma": sigma,
               "lrc": lrc, "constraints": cons}
    if aux is not None:
        tensors["aux"] = (aux, (T, C))
    if z is not None:
        tensors["injected_noise"] = z
    fr._check_tensors(tensors, dev)
    if C != dynamics.CONTROL_DIM or K < 1 or T < 1 or 2 * K * T * C >= 2**31:
        raise ValueError(f"unsupported sizes K={K}, T={T}, C={C}")
    model = fr._model_args(dynamics, cost, dev)
    seed = fr._seed_tensor(seed, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    costs = torch.empty((K,), **f32)
    crash = torch.empty((K,), dtype=torch.int32, device=dev)
    U = torch.empty((K, T, C), **f32)
    carry = torch.empty((-(-K // fr.BLOCK), 2 + T * C), **f32)
    status = getattr(fr._lib(lib_name), entry)(
        dev.index, kind, x0.data_ptr(), mean.data_ptr(), sigma.data_ptr(),
        fr._ptr(aux), lrc.data_ptr(), cons.data_ptr(), seed.data_ptr(), fr._ptr(z),
        K, T, int(stride), fr._f32(sampler.pure_threshold(K)), fr._f32(dt),
        fr._lr_gain(lam, alpha), fr._f32(lam), *model, costs.data_ptr(),
        crash.data_ptr(), U.data_ptr(), carry.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    fr._check_status(status, "fused_solve_kernel")
    _build.count_launch("fused_solve_kernel", entry)
    return costs, crash, U, carry


def fused_solve_carries(dynamics, cost, sampler, x0, mean, seed, dt, lam, alpha,
                        num_rollouts, iteration=0, optimization_stride=0,
                        injected_noise=None):
    """Kernel B3 alone: (costs (K,), crash (K,), U (K, T, C), carry rows)."""
    kind = _solve_kind(sampler)
    if fr._on_cpu(mean):
        return fused_solve_plain(dynamics, cost, sampler, x0, mean, seed, dt, lam,
                                 alpha, num_rollouts, iteration,
                                 optimization_stride, injected_noise)
    return _fused_solve_cuda(dynamics, cost, sampler, kind, x0, mean, seed, dt, lam,
                             alpha, num_rollouts, iteration, optimization_stride,
                             injected_noise)


def fused_solve_iteration(dynamics, cost, sampler, x0, mean, seed, dt, lam, alpha,
                          num_rollouts, iteration=0, optimization_stride=0,
                          return_samples=False, injected_noise=None):
    """One fused MPPI iteration (the JAX ``fused_solve_iteration``,
    pallas_solve.py:480-506): the samples drawn in the kernel from ``seed``
    (a 0-d int32 tensor on the mean's device), normExp weights by the flash
    epilogue. Returns (costs (K,), crash (K,), new_mean (T, C), baseline,
    eta, U (K, T, C) or None): costs include the LR term, baseline =
    min costs, eta = sum exp(-(J - baseline) / lambda), and U (the clamped
    samples) only with ``return_samples``.

    Gaussian and NLN samplers only; ``injected_noise`` replaces the draw
    with given standard normals, (K, T, C) or (2, K, T, C) for NLN.
    ``optimization_stride`` is a host integer."""
    T, C = mean.shape
    costs, crash, U, carry = fused_solve_carries(
        dynamics, cost, sampler, x0, mean, seed, dt, lam, alpha, num_rollouts,
        iteration, optimization_stride, injected_noise)
    new_mean, baseline, eta = fr.flash_combine(carry, T, C, lam)
    return costs, crash, new_mean, baseline, eta, U if return_samples else None
