"""Where the time of one vanilla-MPPI solve of the PyTorch port goes, on one
GPU.

    python3 scripts/torch_solve_breakdown.py [--solves 20]

Flagship configuration (double integrator, circle cost, Gaussian sampler,
K=8192, T=100, one iteration). Prints JSON lines:

* ``parts``: the host wall time of each part of a solve, run on its own and
  synchronized (median over ``--solves`` runs): sampling, the constraint
  clamp, the fused kernels, the weights and free energy, the smoothing and
  the re-rollout of the mean, beside the whole solve.
* ``profile``: a ``torch.profiler`` window over ``--solves`` solves: CUDA
  kernel launches per solve, device busy time per solve (the sum of kernel
  durations), the device's idle share of the window, and the kernels that
  take the most device time.

Needs CUDA; exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mppi_generic_tpu_torch import GaussianDistribution, VanillaMPPI  # noqa: E402
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost  # noqa: E402
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics  # noqa: E402
from mppi_generic_tpu_torch.ops import fused_rollout, weights  # noqa: E402
from mppi_generic_tpu_torch.utils import math_utils  # noqa: E402

K, T = 8192, 100


def wall_ms(fn, n):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--solves", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    ctrl = VanillaMPPI(
        DoubleIntegratorDynamics.create(), DoubleIntegratorCircleCost(),
        GaussianDistribution.create(std_dev=[1.0, 1.0],
                                    control_cost_coeff=[0.01, 0.01]),
        dt=0.02, lam=1.0, alpha=0.0, num_timesteps=T, num_rollouts=K,
        num_iters=1)
    dev = ctrl.device
    cs = ctrl.init_state(seed=0)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0], device=dev)
    mean = cs.control_mean
    sampler = ctrl.sampler
    U = ctrl._clamp_controls(sampler.sample(cs.generator, mean, K)[0])
    lr = (mean, sampler._sigma(T, 0), sampler.control_cost_coeff, ctrl.lam,
          ctrl.alpha, sampler.pure_threshold(K))
    costs, _, new_mean, baseline, _ = fused_rollout.fused_weighted_rollout(
        ctrl.dynamics, ctrl.cost, x, U, ctrl.dt, ctrl.lam, lr_params=lr)

    def weights_and_free_energy():
        w = weights.norm_exp_weights(costs, ctrl.lam, baseline)
        weights.compute_free_energy(w, baseline, ctrl.lam)

    n = args.solves
    parts = {
        "sample": wall_ms(lambda: sampler.sample(cs.generator, mean, K), n),
        "clamp": wall_ms(lambda: ctrl._clamp_controls(U), n),
        "fused_kernels": wall_ms(lambda: fused_rollout.fused_weighted_rollout(
            ctrl.dynamics, ctrl.cost, x, U, ctrl.dt, ctrl.lam, lr_params=lr), n),
        "weights_free_energy": wall_ms(weights_and_free_energy, n),
        "smooth": wall_ms(lambda: math_utils.savitzky_golay_smooth(
            new_mean, cs.control_history), n),
        "mean_trajectory": wall_ms(lambda: ctrl._mean_trajectory(x, new_mean), n),
        "slide": wall_ms(lambda: ctrl.slide_control_sequence(cs, 1), n),
        "solve": wall_ms(lambda: ctrl.solve(x, cs), n),
    }
    print(json.dumps({"phase": "parts", "device": smi, "K": K, "T": T,
                      "host_wall_ms_median": parts}), flush=True)

    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        ctrl.solve(x, cs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            ctrl.solve(x, cs)
        torch.cuda.synchronize()
        window_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        count, total = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (count + 1, total + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    print(json.dumps({
        "phase": "profile", "device": smi, "solves": n,
        "kernel_launches_per_solve": len(kernels) / n,
        "device_busy_us_per_solve": busy_us / n if kernels else "not measured",
        "wall_us_per_solve": window_us / n,
        "device_idle_share": 1.0 - busy_us / window_us if kernels else "not measured",
        "top_kernels": [{"name": name[:80], "launches_per_solve": c / n,
                         "device_us_per_solve": t / n} for name, (c, t) in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
