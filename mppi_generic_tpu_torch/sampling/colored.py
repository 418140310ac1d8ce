"""Colored (1/f^beta power-law) noise sampling distribution, in PyTorch.

Counterpart of ``mppi_generic_tpu/sampling/colored.py`` (reference
``sampling_distributions/colored_noise/colored_noise.{cuh,cu}``, the Timmer &
Koenig (1995) algorithm with NumPy ground truth in ``scripts/colored_noise.py``),
step for step:

* the horizon is oversampled 2x: n = 2 T, F = n / 2 + 1 frequencies
  f_i = i / n; frequencies below max(fmin, 1 / n) are clamped to the first
  one above it;
* per channel the spectrum s_i = f_i^(-beta_c / 2) and the theoretical std
  sigma_c = 2 sqrt(sum_{i >= 1} w_i^2) / n with the Nyquist weight halved
  (n is even);
* real and imaginary frequency noise N(0, 1) s_i, the imaginary part zeroed
  at DC and Nyquist;
* the inverse real DFT of the first T samples, as two matrix products with
  (F, T) cosine and sine bases for T <= 2048 (``torch.fft.irfft`` above),
  divided by sigma_c;
* the re-anchoring y_t - decay^t y_offset at offset = the optimization stride
  (clamped to [0, T - 1], as ``jax.lax.dynamic_slice_in_dim`` clamps), with
  decay 0 when ``offset_decay_rate`` is 0;
* then the Gaussian carve-outs.

The spectrum, the bases and the decay row depend only on the configuration
and the horizon: they are built once in float32 on the CPU, in the JAX
package's order of operations, and cached on the device. The two matrix
products are plain float32 GEMMs; they must run with TF32 off (PyTorch's
default, ``torch.backends.cuda.matmul.allow_tf32``). The normals come from the
explicit ``torch.Generator``; tests hand both packages the same normals
through ``injected_noise``: (2, K, C, F), the real and the imaginary draw.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from mppi_generic_tpu_torch.sampling.gaussian import GaussianDistribution

# horizons up to this length take the inverse-DFT matrix products, longer
# ones torch.fft.irfft (the JAX package's threshold)
DFT_MATMUL_MAX_T = 2048


@functools.lru_cache(maxsize=None)
def _spectrum(exponents: tuple, fmin: float, T: int, device: str):
    """(s (C, F), s_im (C, F), sigma (C,)) for the float32 exponents, in
    the JAX package's operations (colored.py:58-71); s_im is s with its DC
    and Nyquist entries zeroed, the scale of the imaginary draw."""
    n = 2 * T
    F = n // 2 + 1
    f = torch.arange(F, dtype=torch.float32) / n
    cutoff = max(float(np.float32(fmin)), float(np.float32(1.0 / n)))
    first_above = torch.amin(torch.where(f >= cutoff, f, math.inf))
    f_eff = torch.where(f < cutoff, first_above, f)
    beta = torch.tensor(exponents, dtype=torch.float32)
    s = torch.pow(f_eff[None, :], -beta[:, None] / 2.0)
    w = s[:, 1:].clone()
    w[:, -1] = w[:, -1] * 0.5  # the Nyquist weight (n is even)
    sigma = 2.0 * torch.sqrt(torch.sum(w * w, dim=-1)) / n
    s_im = s.clone()
    s_im[:, 0] = 0.0
    s_im[:, -1] = 0.0
    return s.to(device), s_im.to(device), sigma.to(device)


@functools.lru_cache(maxsize=None)
def _idft_bases(T: int, device: str):
    """The (F, T) cosine and sine bases of the first T outputs of the
    inverse real DFT of length n = 2 T, with its 1/n and 2/n scales, built
    as colored.py:87-94 builds them."""
    n = 2 * T
    F = n // 2 + 1
    ang = (2.0 * math.pi / n) * torch.outer(torch.arange(F, dtype=torch.float32),
                                            torch.arange(T, dtype=torch.float32))
    scale = torch.full((F,), 2.0 / n, dtype=torch.float32)
    scale[0] = 1.0 / n
    scale[-1] = 1.0 / n
    basis_c = torch.cos(ang) * scale[:, None]
    basis_s = -torch.sin(ang) * scale[:, None]
    return basis_c.to(device), basis_s.to(device)


@functools.lru_cache(maxsize=None)
def _decay_row(offset_decay: float, T: int, device: str):
    """decay^t for t < T, zero everywhere when the decay is 0."""
    d = torch.tensor(offset_decay, dtype=torch.float32)
    row = torch.pow(d, torch.arange(T, dtype=torch.float32))
    return torch.where(d == 0.0, 0.0, row).to(device)


def frequency_count(num_timesteps: int) -> int:
    """F = n / 2 + 1 with n = 2 T: the length of the frequency draw."""
    return num_timesteps + 1


def powerlaw_psd_gaussian(generator, exponents, num_timesteps, num_samples, fmin=0.0,
                          offset_t=0, offset_decay=0.0, normals=None, device=None):
    """Unit-variance 1/f^beta noise, (num_samples, T, C), contiguous.

    ``exponents``: the (C,) per-channel beta as host numbers. ``normals``
    replaces the draw from ``generator`` with given standard normals
    (2, K, C, F): the real and the imaginary frequency noise before the
    spectrum scales them. ``offset_t`` is a host integer."""
    exponents = tuple(float(np.float32(b)) for b in np.asarray(exponents).reshape(-1))
    C, T, K = len(exponents), int(num_timesteps), int(num_samples)
    F = frequency_count(T)
    if normals is None:
        if device is None:
            device = generator.device if generator is not None else torch.device("cpu")
        normals = torch.randn((2, K, C, F), generator=generator, dtype=torch.float32,
                              device=device)
    elif tuple(normals.shape) != (2, K, C, F):
        raise ValueError(f"colored normals must be (2, {K}, {C}, {F}), got "
                         f"{tuple(normals.shape)}")
    dev = str(normals.device)
    s, s_im, sigma = _spectrum(exponents, float(fmin), T, dev)
    sr = normals[0] * s[None]
    si = normals[1] * s_im[None]  # zero at DC and Nyquist
    if T <= DFT_MATMUL_MAX_T:
        basis_c, basis_s = _idft_bases(T, dev)
        y = torch.matmul(sr, basis_c) + torch.matmul(si, basis_s)
    else:
        y = torch.fft.irfft(torch.complex(sr, si), n=2 * T, dim=-1)[..., :T]
    y = y / sigma[None, :, None]
    o = min(max(int(offset_t), 0), T - 1)
    out = y - y[..., o:o + 1] * _decay_row(float(np.float32(offset_decay)), T, dev)
    return out.transpose(1, 2).contiguous()


class ColoredNoiseDistribution(GaussianDistribution):
    def __init__(self, exponents, std_dev, control_cost_coeff=None,
                 pure_noise_percentage: float = 0.0, std_dev_decay: float = 1.0,
                 offset_decay_rate: float = 0.97, fmin: float = 0.0, device="cpu"):
        super().__init__(std_dev, control_cost_coeff, pure_noise_percentage,
                         std_dev_decay, device=device)
        exps = np.asarray(exponents, np.float32).reshape(-1)
        if exps.shape != (self.CONTROL_DIM,):
            raise ValueError(f"need one exponent per channel ({self.CONTROL_DIM}), "
                             f"got {exps.shape}")
        self.register_buffer("exponents", torch.tensor(exps, device=device))
        # host values: they shape the cached spectrum and reading them must
        # not wait on the device
        self.exponents_host = tuple(float(b) for b in exps)
        self.offset_decay_rate = float(np.float32(offset_decay_rate))
        self.fmin = float(fmin)

    @classmethod
    def create(cls, exponents, std_dev, control_cost_coeff=None,
               pure_noise_percentage: float = 0.0, std_dev_decay: float = 1.0,
               offset_decay_rate: float = 0.97, fmin: float = 0.0, device="cpu"):
        return cls(exponents, std_dev, control_cost_coeff, pure_noise_percentage,
                   std_dev_decay, offset_decay_rate, fmin, device=device)

    def _draw_noise(self, generator, mean, num_rollouts, normals=None,
                    optimization_stride=0):
        """(K, T, C) colored noise re-anchored at ``optimization_stride``;
        ``normals`` (2, K, C, F) replace the draw from ``generator``."""
        T, _ = mean.shape
        return powerlaw_psd_gaussian(
            generator, self.exponents_host, T, num_rollouts, fmin=self.fmin,
            offset_t=optimization_stride, offset_decay=self.offset_decay_rate,
            normals=normals, device=mean.device)
