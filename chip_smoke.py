"""Smoke run of the PyTorch/CUDA port (mppi_generic_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``mppi_generic_tpu_torch/csrc`` (into
``build/torch_kernels/``), holds each kernel against its plain PyTorch
version on the card, and drives the flagship vanilla-MPPI closed loop
(double integrator, circle cost, Gaussian sampler, K=8192, T=100) through
the port's entry points. Each phase prints one JSON line. The line before
the last lists every kernel with its launches on the main path, its error
against the plain version and its times; the last line is
``{"ok": true, "device": {...}}``. Any failed check ends the run with a
non-zero exit and no result line. Without CUDA it exits non-zero at once.

Times come from CUDA events. Each timed call is preceded by a device-side
sleep, so the events measure the device and not the host's enqueue.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from mppi_generic_tpu_torch import GaussianDistribution, VanillaMPPI
from mppi_generic_tpu_torch.costs import DoubleIntegratorCircleCost
from mppi_generic_tpu_torch.models import DoubleIntegratorDynamics
from mppi_generic_tpu_torch.ops import _build
from mppi_generic_tpu_torch.ops import fused_rollout as fr

K_MAIN, K_RAGGED, T, C, S = 8192, 8000, 100, 2, 4
DT, LAM, ALPHA = 0.02, 1.0, 0.0
CLOSED_LOOP_STEPS = 100
N_TIMED, N_TIMED_PLAIN = 100, 10

# one H100 SXM (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# operations per sample-step that the rollout always does (csrc/fused_rollout.cu):
# Euler step 8, circle cost 20 (the crash term's exp/log runs only off the
# track and is not counted), LR 16, accumulate 1
OPS_STEP, OPS_COST, OPS_LR, OPS_ACC = 8, 20, 16, 1

TOL = {  # (rtol, atol)
    # the same operations in the same order: agree to the last bit
    "costs": (1e-5, 1e-6),
    # block sums of w_k U_kj taken in another order; rtol is relative to the
    # sum of absolute terms, since the sums cancel
    "carry": (1e-5, 1e-6),
    # different reduction order over 8192 samples
    "new_mean": (1e-4, 1e-5),
    "baseline": (1e-6, 0.0),
    "eta": (1e-5, 0.0),
}


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(what, got, want, tol, scale=None):
    """Fail unless |got - want| <= atol + rtol * scale everywhere, where
    scale is |want| unless given; return the max abs and rel errors."""
    rtol, atol = TOL[tol]
    got, want = got.double(), want.double()
    scale = want.abs() if scale is None else scale.double()
    err = (got - want).abs()
    rel = err / want.abs().clamp_min(1e-30)
    max_abs, max_rel = float(err.max()), float(rel.max())
    bad = err > atol + rtol * scale
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements outside rtol={rtol} atol={atol}"
            f" (max abs {max_abs}, max rel {max_rel})")
    return {"check": what, "max_abs_err": max_abs, "max_rel_err": max_rel,
            "rtol": rtol, "atol": atol}


def time_ms(fn, n):
    """Median device milliseconds of ``fn`` over ``n`` runs."""
    for _ in range(3):
        fn()
    start = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    end = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    for i in range(n):
        torch.cuda._sleep(1_000_000)
        start[i].record()
        fn()
        end[i].record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(start, end))


def bound_ms(n_bytes, n_ops):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rollout_work(K, epilogue, with_lr):
    """(bytes, operations) the rollout function needs: U, x0, the cost
    parameters and the LR tables read once; costs, crash and the carry
    rows written once."""
    nb = -(-K // fr.BLOCK)
    n_bytes = 4 * (K * T * C + S + len(DoubleIntegratorCircleCost.PARAM_NAMES)
                   + 2 * K)
    per_step = OPS_STEP + OPS_COST + OPS_ACC + (OPS_LR if with_lr else 0)
    n_ops = K * T * per_step + 2 * K
    if with_lr:
        n_bytes += 4 * (2 * T * C + C)
    if epilogue:
        n_bytes += 4 * nb * (2 + T * C)
        n_ops += 5 * K + 2 * K * T * C  # s, max, exp, sum; weighted sum
    return n_bytes, n_ops


def combine_work(nb):
    TC = T * C
    return 4 * (nb * (2 + TC) + TC + 2), 4 * nb + 2 * nb * TC + TC + 1


def make_inputs(dev, K, p, seed):
    """The main path's kernel inputs: samples drawn by the port's sampler
    around a random mean, clamped, and its LR tables."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    dyn = DoubleIntegratorDynamics.create(device=dev)
    cost = DoubleIntegratorCircleCost(device=dev)
    sampler = GaussianDistribution.create(std_dev=[1.0, 1.0],
                                          control_cost_coeff=[0.01, 0.01],
                                          pure_noise_percentage=p, device=dev)
    mean = 0.3 * torch.randn((T, C), generator=g, device=dev)
    U = sampler.sample(g, mean, K)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    x0 = torch.tensor([2.0, 0.0, 0.0, 1.0], device=dev)
    lr = (mean, sampler._sigma(T, 0).contiguous(), sampler.control_cost_coeff,
          LAM, ALPHA, sampler.pure_threshold(K))
    return dyn, cost, x0, U, lr


def kernel_phase(dev, K, p, seed):
    dyn, cost, x0, U, lr = make_inputs(dev, K, p, seed)
    checks, times = [], {}
    # kernel 1, plain-costs mode, without and with the LR cost
    for with_lr in (False, True):
        lrp = lr if with_lr else None
        kc, kcrash = fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp)
        pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp)
        torch.cuda.synchronize()
        checks.append(check(f"costs(lr={with_lr})", kc, pc, "costs"))
        if not torch.equal(kcrash, pcrash):
            raise AssertionError("crash flags differ from the plain version")
        mode = f"costs{'+lr' if with_lr else ''}"
        times[mode] = {
            "ms": time_ms(lambda: fr.fused_rollout_costs(dyn, cost, x0, U, DT, lrp), N_TIMED),
            "plain_ms": time_ms(lambda: fr.rollout_costs_plain(dyn, cost, x0, U, DT, lrp),
                                N_TIMED_PLAIN),
        }
        times[mode]["bound_ms"], times[mode]["bound_by"] = bound_ms(
            *rollout_work(K, False, with_lr))
    # kernel 1, exp-epilogue mode, with LR (the main path's mode)
    kc, kcrash, kcarry = fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lr)
    pc, pcrash = fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)
    pcarry = fr.block_carries_plain(pc, U, LAM)
    checks.append(check("epilogue costs", kc, pc, "costs"))
    # m, d and sum_k w_k |U_kj|: the magnitude each carry entry is summed from
    carry_scale = fr.block_carries_plain(pc, U.abs(), LAM).abs()
    checks.append(check("epilogue carry", kcarry, pcarry, "carry", carry_scale))
    if not torch.equal(kcrash, pcrash):
        raise AssertionError("epilogue crash flags differ from the plain version")
    times["epilogue+lr"] = {
        "ms": time_ms(lambda: fr.rollout_block_carries(dyn, cost, x0, U, DT, LAM, lr),
                      N_TIMED),
        "plain_ms": time_ms(
            lambda: fr.block_carries_plain(
                fr.rollout_costs_plain(dyn, cost, x0, U, DT, lr)[0], U, LAM),
            N_TIMED_PLAIN),
        # one-call yardstick for the weighting + weighted sum (not used by the port)
        "library_ms": time_ms(
            lambda: torch.softmax(-pc / LAM, 0) @ U.view(K, -1), N_TIMED),
    }
    times["epilogue+lr"]["bound_ms"], times["epilogue+lr"]["bound_by"] = bound_ms(
        *rollout_work(K, True, True))
    # kernel 2 on the same (plain) carries, then the whole kernel chain
    km, kb, ke = fr.flash_combine(pcarry, T, C, LAM)
    pm, pb, pe = fr.flash_combine_plain(pcarry, T, C, LAM)
    checks.append(check("flash_combine new_mean", km, pm, "new_mean"))
    checks.append(check("flash_combine baseline", kb, pb, "baseline"))
    checks.append(check("flash_combine eta", ke, pe, "eta"))
    nb = pcarry.shape[0]
    times["flash_combine"] = {
        "ms": time_ms(lambda: fr.flash_combine(pcarry, T, C, LAM), N_TIMED),
        "plain_ms": time_ms(lambda: fr.flash_combine_plain(pcarry, T, C, LAM), N_TIMED),
    }
    times["flash_combine"]["bound_ms"], times["flash_combine"]["bound_by"] = bound_ms(
        *combine_work(nb))
    _, _, fm, fb, fe = fr.fused_weighted_rollout(dyn, cost, x0, U, DT, LAM, lr)
    checks.append(check("fused_weighted_rollout new_mean", fm, pm, "new_mean"))
    checks.append(check("fused_weighted_rollout baseline", fb, pb, "baseline"))
    checks.append(check("fused_weighted_rollout eta", fe, pe, "new_mean"))
    emit("kernels", K=K, T=T, pure_noise_percentage=p, checks=checks, times=times)
    return checks, times


def build_controller(kernel="fused"):
    """The flagship configuration of bench.py build_controller, on the card
    (the controller's default device)."""
    return VanillaMPPI(
        DoubleIntegratorDynamics.create(),
        DoubleIntegratorCircleCost(),
        GaussianDistribution.create(std_dev=[1.0, 1.0],
                                    control_cost_coeff=[0.01, 0.01]),
        dt=DT, lam=LAM, alpha=ALPHA, num_timesteps=T, num_rollouts=K_MAIN,
        num_iters=1, kernel=kernel,
    )


def reference_phase(dev):
    """One full-width solve through the kernels against the eager oracle
    (kernel="combined") on the same injected noise."""
    fused, combined = build_controller("fused"), build_controller("combined")
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    eps = torch.randn((K_MAIN, T, C), generator=g, device=dev)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0], device=dev)
    state = fused.init_state(seed=0)
    rf, _ = fused.solve(x, state, injected_noise=eps)
    rc, _ = combined.solve(x, state, injected_noise=eps)
    checks = [
        check("solve control_mean vs combined", rf.control_mean, rc.control_mean,
              "new_mean"),
        check("solve costs vs combined", rf.costs, rc.costs, "new_mean"),
        check("solve baseline vs combined", rf.baseline, rc.baseline, "eta"),
        check("solve state_trajectory vs combined", rf.state_trajectory,
              rc.state_trajectory, "new_mean"),
    ]
    emit("reference", K=K_MAIN, T=T, checks=checks)


def main_path_phase(dev):
    ctrl = build_controller("fused")
    if ctrl.device.type != "cuda":
        raise AssertionError("the controller did not default to the card")
    cs = ctrl.init_state(seed=0)
    x = torch.tensor([2.0, 0.0, 0.0, 1.0], device=ctrl.device)
    n = CLOSED_LOOP_STEPS
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(n)]
    torch.cuda.synchronize()
    fr.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(n):
        ev[i][0].record()
        cs = ctrl.slide_control_sequence(cs, 1)
        res, cs = ctrl.solve(x, cs)
        ev[i][1].record()
        x, _ = ctrl.dynamics.step(x, res.control_mean[0], 0.0, ctrl.dt)
        ev[i][2].record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(fr.launch_counts)
    for name, count in launches.items():
        if count != n:
            raise AssertionError(f"{name} launched {count} times in {n} solves")
    radius = float(torch.hypot(x[0], x[1]))
    baseline = float(res.baseline)
    if not 1.8 <= radius <= 2.2 or not baseline < 2.0:
        raise AssertionError(f"closed loop did not settle: radius {radius}, "
                             f"baseline {baseline}")
    for name, t in (("control_mean", res.control_mean), ("costs", res.costs),
                    ("state_trajectory", res.state_trajectory)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} is not finite")
    if res.control_mean.shape != (T, C) or res.costs.shape != (K_MAIN,):
        raise AssertionError("unexpected result shapes")
    steady = ev[5:]  # the first solves include one-time allocations
    emit("main_path", K=K_MAIN, T=T, steps=n, launches=launches,
         final_radius=radius, final_baseline=baseline,
         solve_ms_median=statistics.median(e[0].elapsed_time(e[1]) for e in steady),
         step_ms_median=statistics.median(e[0].elapsed_time(e[2]) for e in steady),
         host_wall_ms_per_step=1e3 * wall_s / n)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    t0 = time.perf_counter()
    built = _build.build_all()
    emit("build", seconds=time.perf_counter() - t0,
         ptxas={name: [line.strip() for line in b["log"].splitlines()
                       if "registers" in line or "Compiling entry" in line]
                for name, b in built.items()})

    errs = {"rollout_costs_kernel": 0.0, "flash_combine_kernel": 0.0}
    main_times = None
    for K, p, seed in ((K_MAIN, 0.0, 1), (K_RAGGED, 0.1, 2)):
        checks, times = kernel_phase(dev, K, p, seed)
        for c in checks:
            kernel = ("flash_combine_kernel" if c["check"].startswith("flash_combine")
                      else "rollout_costs_kernel")
            errs[kernel] = max(errs[kernel], c["max_abs_err"])
        if K == K_MAIN:
            main_times = times

    reference_phase(dev)
    launches = main_path_phase(dev)

    epi, comb = main_times["epilogue+lr"], main_times["flash_combine"]
    kernels = [
        {"name": "rollout_costs_kernel", "route": "cuda",
         "source": "mppi_generic_tpu_torch/csrc/fused_rollout.cu",
         "replaces": "mppi_generic_tpu/ops/pallas_rollout.py:548",
         "launches": launches["rollout_costs_kernel"],
         "max_abs_err": errs["rollout_costs_kernel"],
         "ms": epi["ms"], "plain_ms": epi["plain_ms"], "bound_ms": epi["bound_ms"],
         "bound_by": epi["bound_by"], "library_ms": epi["library_ms"],
         "modes": {m: main_times[m] for m in ("costs", "costs+lr", "epilogue+lr")}},
        {"name": "flash_combine_kernel", "route": "cuda",
         "source": "mppi_generic_tpu_torch/csrc/fused_rollout.cu",
         "replaces": "mppi_generic_tpu/ops/pallas_rollout.py:1005",
         "launches": launches["flash_combine_kernel"],
         "max_abs_err": errs["flash_combine_kernel"],
         "ms": comb["ms"], "plain_ms": comb["plain_ms"], "bound_ms": comb["bound_ms"],
         "bound_by": comb["bound_by"], "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
