"""Two checkouts of the PyTorch port compared on the AutoRally fused-solve
loops, in turns, on one GPU.

    python3 scripts/torch_loop_abba.py --other DIR [--steps 30]

Runs the closed loops ``autorally_tsallis_fused_solve`` and
``autorally_smooth_fused_solve`` of ``chip_smoke.py`` (AutoRally's bench
configuration, bench.py:704-717: the 6-32-32-4 network and ARStandardCost on
the 128^2 track map, K=1920, T=150; Tsallis weights with the Gaussian
sampler, and the Smooth-MPPI sampler with its W epilogue) from the checkout
DIR (A) and from this one (B), in the order A B B A, each run in a fresh
process that imports that checkout's ``chip_smoke.py`` and port and builds
its kernels into that checkout's ``build/``. Each run prints one JSON line
per loop: the median solve and step ms over the steps after the fifth (CUDA
events), the host wall ms per step and the launches per step. The last
line holds every run's medians in turn order.

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

ROOT = Path(__file__).resolve().parents[1]


def loops(root, steps):
    """The two loops of the checkout ``root``: {loop: its medians}."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    from mppi_generic_tpu_torch import SmoothMPPIDistribution, VanillaMPPI
    from mppi_generic_tpu_torch.ops import fused_rollout as fr

    dev = torch.device("cuda")
    dyn, cost = cs.ar_parts("128")  # as chip_smoke.py's pair_loops builds them
    ar = dict(dt=cs.DT, lam=cs.LAM, alpha=cs.ALPHA, num_timesteps=cs.T_AR,
              num_rollouts=cs.K_AR, num_iters=1, kernel="fused_solve", split_cost=False)
    ctrls = {
        "autorally_tsallis_fused_solve": VanillaMPPI(
            dyn, cost, cs.ar_sampler("gaussian"), weight_transform="tsallis",
            tsallis_gamma=cs.GAMMA, tsallis_r=cs.R_TS, **ar),
        "autorally_smooth_fused_solve": VanillaMPPI(
            dyn, cost, SmoothMPPIDistribution.create(
                std_dev=cs.AR_STD, control_cost_coeff=[1.0] * cs.C, num_timesteps=cs.T_AR,
                dt=cs.DT_SMOOTH), **ar),
    }
    out = {}
    for name, ctrl in ctrls.items():
        state, x = ctrl.init_state(seed=0), cs.ar_x0(dev)
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in range(steps)]
        torch.cuda.synchronize()
        fr.reset_launch_counts()
        t0 = time.perf_counter()
        for i in range(steps):
            ev[i][0].record()
            state = ctrl.slide_control_sequence(state, 1)
            res, state = ctrl.solve(x, state)
            ev[i][1].record()
            x = ctrl.dynamics.step(x, res.control_mean[0], 0.0, ctrl.dt)[0]
            ev[i][2].record()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"{name}: the state is not finite")
        steady = ev[5:]
        out[name] = {
            "solve_ms_median": statistics.median(e[0].elapsed_time(e[1]) for e in steady),
            "step_ms_median": statistics.median(e[0].elapsed_time(e[2]) for e in steady),
            "host_wall_ms_per_step": 1e3 * wall_s / steps,
            "launches_per_step": sum(fr.launch_counts.values()) / steps,
            "launches": {k: v for k, v in fr.launch_counts.items() if v}}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", type=Path, help="the checkout A, run first and last")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps({"root": str(args.child), "loops": loops(args.child, args.steps)}),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or args.other is None:
        print("needs CUDA and --other", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    turns = []
    for label, root in (("A", args.other), ("B", ROOT), ("B", ROOT), ("A", args.other)):
        run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                              str(root.resolve()), "--steps", str(args.steps)],
                             capture_output=True, text=True, cwd=root)
        if run.returncode != 0:
            print(run.stdout, run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        res = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": label, **res}), flush=True)
        turns.append((label, res["loops"]))
    print(json.dumps({"abba_solve_ms_median": {
        name: [[label, loops_[name]["solve_ms_median"]] for label, loops_ in turns]
        for name in turns[0][1]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
