"""Counter-based normals: the plain version of ``csrc/philox.cuh``.

The TPU kernels draw their noise from the TPU's hardware PRNG
(``pltpu.prng_seed`` / ``prng_random_bits``, pallas_solve.py:172, :184-197
and pallas_rollout.py:1725, :1749-1756), a generator whose stream depends
on the tile a grid step draws for. The Hopper kernels use Philox4x32-10
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011)
instead, and make every normal a pure function of
(seed, sample k, step t, channel c, stream):

* counter = (k, t, c // 2, 0), key = (seed, 0); one Philox4x32-10 call
  gives four 32-bit words w0..w3;
* stream s (0: the normal z, 1: NLN's second normal z2) takes the pair
  (w[2s], w[2s + 1]) through the Box-Muller transform of the JAX kernels
  (pallas_solve.py:187-197):
  u1 = ((w[2s] >> 8) + 0.5) * 2^-24, u2 = (w[2s + 1] >> 8) * 2^-24,
  r = sqrt(-2 log u1), theta = 2 pi u2;
* channel 2p takes r cos(theta), channel 2p + 1 takes r sin(theta).

So neither the kernel's thread layout nor the slice of samples a call
draws changes a single value, and this module reproduces the kernel's
draw: the integer part exactly, the float part with the same float32
operations in the same order.

PyTorch has no uint32 multiply with a high word, so the 32 x 32 -> 64-bit
products of the Philox rounds are formed in int64 from 16-bit halves.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["nln_moments", "normal_battery", "normals", "philox4x32"]

_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57  # round multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85  # key schedule (Weyl) constants
ROUNDS = 10
TWO_PI = 6.2831853071795864  # rounded to float32 where it is used
INV_2_24 = 2.0 ** -24


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a constant m < 2^32 and an int64
    tensor x of values < 2^32, exactly."""
    mh, ml = m >> 16, m & 0xFFFF
    xh, xl = x >> 16, x & 0xFFFF
    mid = mh * xl + ml * xh  # < 2^33
    low = ml * xl + ((mid & 0xFFFF) << 16)  # < 2^33
    hi = mh * xh + (mid >> 16) + (low >> 32)
    return hi & _MASK, low & _MASK


def philox4x32(ctr, key):
    """Philox4x32-10 of the counter words ``ctr`` (4 int64 tensors or ints,
    values < 2^32, broadcasting) under ``key`` (2 of them). Returns the four
    output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in ctr)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _box_muller(w_a, w_b):
    """Two standard normals (r cos theta, r sin theta) from two words, in
    the kernel's float32 operations."""
    f1 = (w_a >> 8).to(torch.float32)
    f2 = (w_b >> 8).to(torch.float32)
    u1 = (f1 + 0.5) * INV_2_24
    u2 = f2 * INV_2_24
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = TWO_PI * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def normals(seed, K: int, T: int, C: int, streams: int = 1, k0: int = 0,
            device=None) -> torch.Tensor:
    """(streams, K, T, C) float32 standard normals of samples k0 .. k0+K-1,
    as the kernels draw them. ``seed`` is an int or a 0-d integer tensor
    (the controllers keep it on the device); all draws are computed at once,
    vectorized over (K, T, ceil(C / 2))."""
    if not isinstance(seed, torch.Tensor):
        seed = torch.tensor(int(seed), device=device)
    dev = seed.device
    P = -(-C // 2)
    k = torch.arange(k0, k0 + K, dtype=torch.int64, device=dev)[:, None, None]
    t = torch.arange(T, dtype=torch.int64, device=dev)[None, :, None]
    p = torch.arange(P, dtype=torch.int64, device=dev)[None, None, :]
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    words = philox4x32((k, t, p, zero), (seed.to(torch.int64) & _MASK, zero))
    out = []
    for s in range(streams):
        a, b = _box_muller(words[2 * s], words[2 * s + 1])
        z = torch.stack([a, b], dim=-1).reshape(K, T, 2 * P)[..., :C]
        out.append(z)
    return torch.stack(out)


# ---------------------------------------------------------------------------
# statistics of a draw: the battery of the JAX package's hardware-PRNG check
# (scripts/tpu_selfcheck.py:86-154), used by the tests and by chip_smoke.py
# ---------------------------------------------------------------------------
def _corr(a, b) -> float:
    return float(torch.corrcoef(torch.stack([a.reshape(-1), b.reshape(-1)]))[0, 1])


def normal_battery(eps: torch.Tensor) -> dict:
    """Statistics of (K, T, C >= 2) draws that should be iid N(0, 1): mean,
    std, skew, kurtosis, and the correlations between the two halves of the
    sample axis, along time (lag 1) and across the first two channels."""
    e = eps.double()
    flat = e.reshape(-1)
    half = e.shape[0] // 2
    return {
        "mean": float(flat.mean()),
        "std": float(flat.std()),
        "skew": float((flat ** 3).mean()),
        "kurtosis": float((flat ** 4).mean()),
        "r_blocks": _corr(e[: half - 1], e[half: 2 * half - 1]),
        "r_time": _corr(e[:, :-1, 0], e[:, 1:, 0]),
        "r_channels": _corr(e[..., 0], e[..., 1]),
    }


def normal_battery_failures(stats: dict) -> list:
    """The limits of tpu_selfcheck.py:102-118 that ``stats`` breaks."""
    limits = {"mean": (0.0, 0.01), "std": (1.0, 0.01), "skew": (0.0, 0.02),
              "kurtosis": (3.0, 0.1), "r_blocks": (0.0, 0.01),
              "r_time": (0.0, 0.01), "r_channels": (0.0, 0.01)}
    return [f"{name} {stats[name]} not within {want} +- {tol}"
            for name, (want, tol) in limits.items()
            if not abs(stats[name] - want) < tol]


def nln_moments(eps: torch.Tensor, s: float) -> dict:
    """Moments of NLN noise eps = z * exp(s z2) against their law
    (tpu_selfcheck.py:121-149): E = 0, Var = exp(2 s^2), kurtosis =
    3 exp(4 s^2)."""
    flat = eps.double().reshape(-1)
    var = float(flat.var())
    var_want = float(np.exp(2.0 * s * s))
    kurt = float((flat ** 4).mean()) / float((flat ** 2).mean()) ** 2
    kurt_want = 3.0 * float(np.exp(4.0 * s * s))
    return {"mean": float(flat.mean()), "var": var, "var_want": var_want,
            "kurtosis": kurt, "kurtosis_want": kurt_want}


def nln_moment_failures(m: dict) -> list:
    """The limits of tpu_selfcheck.py:147-149 that ``m`` breaks."""
    out = []
    if not abs(m["mean"]) < 0.02:
        out.append(f"mean {m['mean']}")
    if not abs(m["var"] / m["var_want"] - 1.0) < 0.03:
        out.append(f"var {m['var']} against {m['var_want']}")
    if not abs(m["kurtosis"] / m["kurtosis_want"] - 1.0) < 0.25:
        out.append(f"kurtosis {m['kurtosis']} against {m['kurtosis_want']}")
    return out
