"""B1's staged producer: plain coalesced loads against cp.async copies.

The staged B1 (``rollout_costs_staged_kernel``, ``csrc/rollout_kernel.cuh``)
fills the shared stage with each sample's chunk of U either by plain loads
and stores or by ``cp.async`` copies (4-byte copies into the padded stage;
with LR each lane reads its slots back for the LR term); the port picks one
per model (``RolloutCopies``). This script builds the staged pairs'
sources twice beside the port's build, with ``-DMPPI_ROLLOUT_COPY=0`` (plain
loads for every model) and ``=1`` (cp.async for every model), checks that
both give the same floats, and times B1 (costs; the exp epilogue with LR) at
each pair's path shape A B B A: loads, copy, copy, loads (CUDA events,
medians of 100 runs). One JSON line per pair; needs a CUDA card with nvcc:

    python3 scripts/torch_staged_copy_trial.py
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

PAIRS = ("di_circle", "cartpole", "quadrotor_quadratic", "quadrotor_map", "dubins_quadratic",
         "bicycle_ar")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_staged_copy_trial: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    _build.build_all()
    loads, copy = {}, {}
    sources = tuple(sorted({_build.pair_entry(p, "rollout")[0] for p in PAIRS}))
    cs.build_variants(((loads, ("MPPI_ROLLOUT_COPY=0",), "rollout_loads", sources),
                       (copy, ("MPPI_ROLLOUT_COPY=1",), "rollout_copy", sources)))
    for i, pair in enumerate(PAIRS):
        K, _, T_ = cs.pair_shape(pair)
        dyn, cost, x0, std, offset, _ = cs.staged_parts(pair, dev)
        C_ = dyn.CONTROL_DIM
        g = torch.Generator(device=dev).manual_seed(600 + i)
        mean = 0.3 * torch.randn((T_, C_), generator=g, device=dev)
        mean[:, -1] += offset
        samp = cs.zoo_sampler("gaussian", C_, std, dev, 0.0, T_)
        U, _ = samp.sample(g, mean, K)
        U = dyn.enforce_constraints(None, U.permute(2, 0, 1)).permute(1, 2, 0).contiguous()
        lr = (mean, samp._sigma(T_, 0).contiguous(), samp.control_cost_coeff, cs.LAM,
              cs.ALPHA, samp.pure_threshold(K))
        # RolloutCopies (csrc/rollout_kernel.cuh): the port's choice
        out = {"pair": pair, "K": K, "T": T_, "port_copies": dyn.STATE_DIM <= 4}
        for mode, lrp, epi in (("costs", None, fr.EPI_NONE), ("epilogue+lr", lr, fr.EPI_EXP)):
            def run(lrp=lrp, epi=epi):
                return fr._rollout_cuda(dyn, cost, x0, U, cs.DT, lrp, epi, cs.LAM)

            with cs.swapped(loads):
                a = run()
            with cs.swapped(copy):
                b = run()
            torch.cuda.synchronize()
            for x, y in zip(a, b):
                if x is not None and not torch.equal(x, y):
                    raise AssertionError(f"{pair} {mode}: the two builds differ")
            turns = []
            for libs in (loads, copy, copy, loads):
                with cs.swapped(libs):
                    turns.append(cs.time_ms(run, cs.N_TIMED))
            loads_ms, copy_ms = (turns[0], turns[3]), (turns[1], turns[2])
            out[mode] = {"plain_loads_ms": sum(loads_ms) / 2, "cp_async_ms": sum(copy_ms) / 2,
                         "abba_ms": turns, "plain_loads_faster": max(loads_ms) < min(copy_ms),
                         "cp_async_faster": max(copy_ms) < min(loads_ms)}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
