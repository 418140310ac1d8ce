"""The network pairs' combined B1 in its warp form, timed against what it
replaces and against B1's split form.

For AutoRally (1920 x 150, the bench's 128^2 map), the racer LSTM-steering
row (1920 x 100) and the LSTM-uncertainty row (1920 x 150), in B1's five
modes (costs, costs + LR, the exp epilogue with and without LR, Tsallis
pass 1 + LR), and for AutoRally's per-sample-x0 entry at RMPPI stage 1's 9
candidates x 256 samples (ARRobustCost, costs), this script launches B1
through ``fr.rollout_block_carries`` / ``rollout_block_minima`` /
``fused_rollout_costs``:

* the warp form (``rollout_costs_warp_kernel`` and its epilogue pass) A B B
  A against the one-thread ``rollout_costs_kernel`` of the same sources
  built with -DMPPI_SOLVE_ONE_THREAD -DMPPI_ROLLOUT_ONE_THREAD (CUDA events,
  medians of 100 runs; in the paths' modes the profiler's device time too),
  after checking that both give the same bits;
* in the mode AUTO decides on (epilogue + LR; costs for the x0 entry) the
  combined kernel (``split_cost=False``) against the split form
  (``split_cost=True``): combined, split, split, combined, the A B B A that
  sets the pair's ``("...", "rollout")`` and ``("ar_nn", "rollout_x0")``
  rows of ``fr.AUTO_SPLIT``: the split only where both split times are below
  both combined times.

Prints the card (``nvidia-smi``), the ptxas lines of the sources and one
JSON line per case; needs a CUDA card with nvcc:

    python3 scripts/torch_network_rollout_abba.py
"""

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from mppi_generic_tpu_torch.ops import _build  # noqa: E402
from mppi_generic_tpu_torch.ops import fused_rollout as fr  # noqa: E402

MODES = ("costs", "costs+lr", "epilogue", "epilogue+lr", "tsallis+lr")
# the modes timed also by the profiler and against the split form (the AUTO
# rows' modes), with the kernels of one launch of the warp form
DEVICE_KERNELS = {("rollout", "epilogue+lr"): ("rollout_costs_warp_kernel", cs.CARRY),
                  ("rollout_x0", "costs"): ("rollout_costs_warp_kernel",)}


def rollout_fn(dyn, cost, x0, U, lr, mode):
    """B1 of ``mode`` as a function of its split choice."""
    lrp = lr if mode.endswith("+lr") else None

    def run(split):
        if mode.startswith("epilogue"):
            return fr.rollout_block_carries(dyn, cost, x0, U, cs.DT, cs.LAM, lrp,
                                            split_cost=split)
        if mode.startswith("tsallis"):
            return fr.rollout_block_minima(dyn, cost, x0, U, cs.DT, lrp, split_cost=split)
        return fr.fused_rollout_costs(dyn, cost, x0, U, cs.DT, lrp, split_cost=split)

    return run


def cases(dev):
    """(label, pair, kind, dynamics, cost, x0, U, LR tables) of each case."""
    out = []
    for pair in cs.WARP_PAIRS:
        if pair == "ar_nn":
            dyn, cost = cs.ar_parts("128", dev)
            x0, K, T = cs.ar_x0(dev), cs.K_AR, cs.T_AR
        else:
            dyn, cost = cs.racer_parts(pair, dev)
            x0, K, T = cs.racer_x0(pair, dev), cs.K_RC, cs.T_RACER[pair]
        g = torch.Generator(device=dev).manual_seed(K + T)
        mean = 0.2 * torch.randn((T, cs.C), generator=g, device=dev)
        samp = cs.ar_sampler("gaussian", dev, 0.1)
        U, _ = samp.sample(g, mean, K)
        U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
        lr = (mean, samp._sigma(T, 0).contiguous(), samp.control_cost_coeff, cs.LAM, cs.ALPHA,
              samp.pure_threshold(K))
        out.append((f"{pair} {K} x {T}", pair, "rollout", dyn, cost, x0, U, lr))
    # RMPPI stage 1 on AutoRally: 9 candidates on a segment, 256 samples each
    dyn, cost = cs.robust_ar_parts("128", dev)
    K = cs.N_CAND_AR * cs.S_PER_AR
    g = torch.Generator(device=dev).manual_seed(K)
    w = torch.linspace(0.0, 1.0, cs.N_CAND_AR, device=dev)[:, None]
    cand = cs.ar_x0(dev) + w * torch.tensor([0.1, 0.05, 0.02, 0.0, 0.1, 0.0, 0.0], device=dev)
    x0s = cand.repeat_interleave(cs.S_PER_AR, dim=0).contiguous()
    mean = 0.2 * torch.randn((cs.T_AR, cs.C), generator=g, device=dev)
    U, _ = cs.ar_sampler("gaussian", dev).sample(g, mean, K)
    U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
    out.append((f"ar_nn x0 {cs.N_CAND_AR} x {cs.S_PER_AR} x {cs.T_AR}", "ar_nn", "rollout_x0",
                dyn, cost, x0s, U, None))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    built = _build.build_all()
    variant = [v for v in cs.VARIANTS if v[0] is cs.SOLVE_ONE_THREAD]
    logs = cs.build_variants(variant)
    keep = ("registers", "Compiling entry", "stack frame")
    for name, log in [(n, built[n]["log"]) for n in cs.WARP_SOLVE_SOURCES] + list(logs.items()):
        lines = [ln.strip() for ln in log.splitlines() if any(k in ln for k in keep)]
        print(json.dumps({"ptxas": name, "lines": lines}), flush=True)

    for label, pair, kind, dyn, cost, x0, U, lr in cases(dev):
        modes = ("costs",) if kind == "rollout_x0" else MODES
        for mode in modes:
            run = rollout_fn(dyn, cost, x0, U, lr, mode)
            got = run(False)
            with cs.one_thread_solve():
                one = run(False)
            torch.cuda.synchronize()
            cs.same_bits(f"{label} {mode}", got, one)
            row = {"case": label, "mode": mode, "form": cs.b1_kernel(pair, kind == "rollout_x0"),
                   "crashed_share": float(got[1].float().mean()),
                   "one_thread_abba": cs.abba_against(lambda: run(False), cs.one_thread_solve)}
            names = DEVICE_KERNELS.get((kind, mode))
            if names:
                row["one_thread_device"] = cs.device_abba(lambda: run(False), names,
                                                          "rollout_costs_kernel",
                                                          cs.one_thread_solve)
                row["split_abba"] = cs.abba(lambda: run(False), lambda: run(True))
                row["auto_split_now"] = fr.AUTO_SPLIT.get((pair, kind))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
