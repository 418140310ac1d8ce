"""The staged form of the split dynamics passes, timed against what it
replaces, the split form against the combined kernels, and the combined
staged kernels against another checkout's build.

For each pair whose split dynamics passes take the staged form
(``csrc/split_staged.cuh``: the DI circle and quadratic, the cartpole, the
quadrotor, Dubins at 8192 x 100; the bicycle's B3 pass at 1920 x 100; the DI
robust cost's B1 pass from one x0 per sample at 9 x 64 x 48), this script

* prints the ptxas lines (registers, stack, spill) of every staged kernel of
  the split sources and of the pairs' combined sources;
* checks each staged pass against the one-thread pass of the same sources
  built with -DMPPI_SPLIT_ONE_THREAD (``chip_smoke.py``'s variant): Y, U and
  the LR sums the same bits;
* times each pass A B B A against that one-thread pass (CUDA events, medians
  of 100 runs; B3's Gaussian and NLN);
* times the whole split form against the combined kernel, combined, split,
  split, combined: B1 with the exp epilogue and LR, B3 Gaussian, the
  per-sample-x0 B1 with costs alone, the A B B A that sets a pair's row of
  ``fr.AUTO_SPLIT`` (split only where both split times are below both
  combined times);
* with ``--other DIR`` (a checkout, e.g. the parent unpacked by ``git
  archive`` under ``build/``), builds that checkout's combined sources beside
  the port's and times the combined staged B1, B3 and B4 of each pair in
  turns, other, this, this, other, with their ptxas lines side by side.

``--no-time`` stops after the ptxas lines and the checks. Needs a CUDA card
with nvcc; about 5 minutes on an H100 with the builds:

    python3 scripts/torch_split_staged_abba.py [--other build/parent] [--no-time]
"""

import argparse
import concurrent.futures
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mppi_generic_tpu_torch.ops import _build, fused_solve  # noqa: E402
from mppi_generic_tpu_torch.ops import fused_rollout as fr  # noqa: E402

PAIRS = ("di_circle", "di_quadratic", "cartpole", "quadrotor_quadratic", "dubins_quadratic",
         "bicycle_ar")


def ptxas_table(log):
    """{demangled kernel: (registers, stack bytes, spill stores, spill loads)}
    of the staged kernels in an nvcc log with -Xptxas -v."""
    out, name, frame = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = subprocess.run(["c++filt", m.group(1)], capture_output=True,
                                  text=True).stdout.strip()
            name = re.sub(r"\(anonymous namespace\)::", "", name).split("(")[0]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill",
                      line)
        if m:
            frame = tuple(int(v) for v in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None and "staged" in name:
            out[name] = (int(m.group(1)), *frame)
            name = None
    return out


def robust_inputs(dev):
    """The DI robust cost's RMPPI candidates at the rmppi_di_robust loop's
    shape (9 x 64 x 48, chip_smoke.split_x0_phase): (dynamics, cost, x0s,
    U)."""
    dyn, cost = (cs.DoubleIntegratorDynamics.create(device=dev),
                 cs.DoubleIntegratorRobustCost(device=dev))
    w = torch.linspace(0.0, 1.0, cs.N_CAND_AR, device=dev)[:, None]
    x0 = torch.tensor(cs.X0_RDI, device=dev)
    dx = torch.tensor([0.3, 0.1, 0.4, -0.3], device=dev)
    X0 = (x0[None] + w * dx[None]).repeat_interleave(cs.S_PER_RDI, dim=0).contiguous()
    g = torch.Generator(device=dev).manual_seed(131)
    U = torch.randn((X0.shape[0], cs.T_RDI, cs.C), generator=g, device=dev).contiguous()
    return dyn, cost, X0, U


def pair_inputs(pair, dev):
    """(dynamics, cost, x0, mean, U, LR tables, samplers, seed, K) of
    ``pair`` at its loops' shape (chip_smoke.split_inputs)."""
    K = cs.K_MAIN if pair == "di_circle" else cs.pair_shape(pair)[0]
    dyn, cost, x0, mean, U, lr, samplers, _ = cs.split_inputs(dev, pair, K, 0.0, 0, 91, None)
    return dyn, cost, x0, mean, U, lr, samplers, torch.tensor(
        K + 5, dtype=torch.int32, device=dev), K


def pass_cases(pair, dev):
    """[(label, kind, launch)] of ``pair``'s staged passes at its loops'
    shapes: B1's split pass, B3's Gaussian and NLN (the DI robust cost: its
    per-sample-x0 B1 pass), each launch returning its outputs."""
    if pair == "di_robust":
        dyn, cost, X0, U = robust_inputs(dev)
        return [("B1-x0", "split_dynamics_x0",
                 lambda: (fr.split_dynamics_cuda(dyn, cost, X0, U, cs.DT),))]
    dyn, cost, x0, mean, U, _, samplers, seed, K = pair_inputs(pair, dev)
    cases = []
    if cs.earlier_form(pair, "split_dynamics") is not None:
        cases.append(("B1", "split_dynamics",
                      lambda: (fr.split_dynamics_cuda(dyn, cost, x0, U, cs.DT),)))
    for kind, samp in samplers.items():
        args = (dyn, cost, samp, fr.noise_kind(samp), x0, mean, seed, cs.DT, K, 0, 0, None)
        cases.append((f"B3 {kind}", "split_solve_dynamics",
                      lambda args=args: fused_solve.split_solve_dynamics_cuda(*args)))
    return cases


def form_cases(pair, dev):
    """[(row, combined kernel, split form or None)] of ``pair``: the AUTO
    rows, B1 with the exp epilogue and LR and B3 Gaussian, whose combined
    staged kernels are also timed against the other build, and B4 Gaussian
    (that alone); the DI robust cost: B1 from one x0 per sample, costs
    alone."""
    if pair == "di_robust":
        dyn, cost, X0, U = robust_inputs(dev)
        return [("rollout_x0", lambda: fr._rollout_cuda(dyn, cost, X0, U, cs.DT, None),
                 lambda: fr.split_rollout_cuda(dyn, cost, X0, U, cs.DT, None))]
    dyn, cost, x0, mean, U, lr, samplers, seed, K = pair_inputs(pair, dev)
    args = (dyn, cost, samplers["gaussian"], x0, mean, seed, cs.DT, cs.LAM, cs.ALPHA, K)
    b1 = lambda: fr._rollout_cuda(dyn, cost, x0, U, cs.DT, lr, fr.EPI_EXP, cs.LAM)  # noqa: E731
    b3 = lambda: fused_solve.fused_solve_carries(*args, split_cost=False)  # noqa: E731
    return [("rollout", b1,
             lambda: fr.split_rollout_cuda(dyn, cost, x0, U, cs.DT, lr, fr.EPI_EXP, cs.LAM)),
            ("solve", b3, lambda: fused_solve.fused_solve_carries(*args, split_cost=True)),
            ("B4", lambda: fr.fused_sample_rollout_costs(*args), None)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="a checkout whose combined staged kernels to time")
    ap.add_argument("--no-time", action="store_true")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    combined = tuple(sorted({_build.pair_entry(p, "solve")[0] for p in PAIRS + ("di_robust",)}
                            | {_build.pair_entry("di_circle", "rollout_x0")[0]}))
    built = _build.build_all()
    variant = tuple(v for v in cs.VARIANTS if v[0] is cs.ONE_THREAD)
    other_libs, other_logs = {}, {}
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        if opts.other:
            pending = pool.submit(
                cs.build_variants, ((other_libs, (), "other_build", combined),),
                Path(opts.other).resolve() / "mppi_generic_tpu_torch" / "csrc")
        cs.build_variants(variant)
        if opts.other:
            other_logs = {k.split("/", 1)[1]: log for k, log in pending.result().items()}
    for name in sorted(n for n in built if n.startswith("split_") or n in combined):
        table = ptxas_table(built[name]["log"])
        other = ptxas_table(other_logs[name]) if name in other_logs else {}
        for kern, regs in sorted(table.items()):
            row = {"ptxas": name, "kernel": kern,
                   "registers_stack_spill_stores_loads": regs}
            if name in other_logs:
                row["other"] = other.get(kern)
            print(json.dumps(row), flush=True)

    for pair in PAIRS + ("di_robust",):
        for label, kind, run in pass_cases(pair, dev):
            got = run()
            with cs.one_thread_split():
                one = run()
            torch.cuda.synchronize()
            cs.same_bits(f"{pair} {label}", got, one)
            row = {"pair": pair, "pass": label, "kernel": cs.split_name(pair, kind),
                   "same_bits_as_one_thread": True}
            if not opts.no_time:
                row["one_thread_abba"] = cs.abba_against(run, cs.one_thread_split)
            print(json.dumps(row), flush=True)
    if opts.no_time:
        return 0

    other = lambda: cs.swapped(other_libs)  # noqa: E731
    for pair in PAIRS + ("di_robust",):
        for row, comb, split in form_cases(pair, dev):
            out = {"pair": pair, "row": row}
            if split is not None:
                out["split_abba"] = cs.abba(comb, split)
            if other_libs:
                got = comb()
                with other():
                    was = comb()
                torch.cuda.synchronize()
                cs.same_bits(f"{pair} {row} (other build)", got, was)
                out["combined_other_abba"] = cs.abba_against(comb, other)
            print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
